"""Host-side helpers of the port: PNG I/O and image resampling."""
