"""Backend selection for the port (the counterpart of seaweedfs_tpu.tpu)."""
