"""Input data for the port: synthetic samples and batches (``synthetic``) and
the batch loader (``loader``). The KITTI readers of ``monorec_tpu.data`` come
with a later port slice."""
