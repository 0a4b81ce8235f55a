"""Input data for the port: the KITTI Odometry reader (``kitti``, with its
PNG reader ``png`` and PIL-exact resize ``resize``), the Oxford RobotCar
reader (``robotcar``, with the cv2-exact Bayer demosaic ``bayer``), the TUM
mono VO reader (``tum_mono_vo``, with the PIL-exact baseline greyscale JPEG
decoder ``jpeg``) and the TUM RGB-D reader (``tum_rgbd``), their pose
interpolation (``pose_interp``), the sample cache (``cache``), synthetic
samples and batches (``synthetic``), the host-side colour jitter
(``color_jitter``) and the batch loader (``loader``). None imports PIL or
cv2."""
