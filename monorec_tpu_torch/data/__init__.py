"""Input data for the port. Only synthetic batches so far: the KITTI readers
of ``monorec_tpu.data`` come with a later port slice."""
