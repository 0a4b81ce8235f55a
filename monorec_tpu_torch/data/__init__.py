"""Input data for the port: the KITTI Odometry reader (``kitti``, with its
PNG reader ``png`` and PIL-exact resize ``resize``), the sample cache
(``cache``), synthetic samples and batches (``synthetic``), the host-side
colour jitter (``color_jitter``) and the batch loader (``loader``). The
RobotCar and TUM readers of ``monorec_tpu.data`` are not ported yet."""
