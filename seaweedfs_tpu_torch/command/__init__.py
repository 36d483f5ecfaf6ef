"""The command line (`python -m seaweedfs_tpu_torch <command>`)."""
