"""SE(3) pose interpolation over timestamps (numpy), the port's copy of
``monorec_tpu/data/pose_interp.py`` for the RobotCar and TUM readers:
quaternion slerp for the rotation and a linear translation between the two
poses bracketing each query timestamp, the RobotCar SDK's ``xyzrpy``
convention, and the integration of a RobotCar ``vo.csv`` (relative poses
chained left to right). It gives the JAX package's poses bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def se3_from_xyzrpy(x: Sequence[float]) -> np.ndarray:
    """[x, y, z, roll, pitch, yaw] -> 4x4 (RobotCar extrinsics convention)."""
    tx, ty, tz, r, p, y = x
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = rz @ ry @ rx
    m[:3, 3] = (tx, ty, tz)
    return m


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(m[:3, :3])
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    i = np.argmax([m[0, 0], m[1, 1], m[2, 2]])
    if i == 0:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        return np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        )
    if i == 1:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        return np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
        )
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    return np.array(
        [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    )


def matrix_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    dot = float(np.dot(q0, q1))
    if dot < 0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(dot, -1, 1))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


def interpolate_poses(
    pose_times: Sequence[float],
    poses: Sequence[np.ndarray],
    query_times: Sequence[float],
    origin_time: float,
) -> List[np.ndarray]:
    """Interpolate 4x4 poses at query timestamps, re-based to origin_time."""
    pose_times = np.asarray(pose_times, dtype=np.float64)
    quats = [quat_from_matrix(np.asarray(p)) for p in poses]
    trans = [np.asarray(p)[:3, 3] for p in poses]

    def at(t: float) -> np.ndarray:
        i = int(np.searchsorted(pose_times, t))
        i = np.clip(i, 1, len(pose_times) - 1)
        t0, t1 = pose_times[i - 1], pose_times[i]
        frac = 0.0 if t1 == t0 else float((t - t0) / (t1 - t0))
        frac = float(np.clip(frac, 0.0, 1.0))
        q = _slerp(quats[i - 1], quats[i], frac)
        tr = (1 - frac) * trans[i - 1] + frac * trans[i]
        m = np.eye(4)
        m[:3, :3] = matrix_from_quat(q)
        m[:3, 3] = tr
        return m

    origin = at(float(origin_time))
    origin_inv = np.linalg.inv(origin)
    return [origin_inv @ at(float(t)) for t in query_times]


def integrate_vo(
    rel_times: np.ndarray, rel_poses: List[np.ndarray]
) -> List[np.ndarray]:
    """Chain relative VO transforms into absolute poses (first pose = I)."""
    out = [np.eye(4)]
    for rp in rel_poses:
        out.append(out[-1] @ rp)
    return out


def interpolate_vo_poses(
    vo_path, query_times: Sequence[float], origin_time: float
) -> List[np.ndarray]:
    """Read a RobotCar vo.csv (source_ts, dest_ts, x, y, z, r, p, y rows),
    integrate to absolute poses, and interpolate at query timestamps."""
    data = np.genfromtxt(vo_path, delimiter=",", skip_header=1)
    dest_times = data[:, 0]
    abs_poses = [np.eye(4)]
    times = [data[0, 1]]
    for row in data:
        rel = se3_from_xyzrpy(row[2:8])
        abs_poses.append(abs_poses[-1] @ rel)
        times.append(row[0])
    return interpolate_poses(times, abs_poses, query_times, origin_time)
