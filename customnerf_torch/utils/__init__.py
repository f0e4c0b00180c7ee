"""Host-side helpers of the port: PNG and JPEG I/O, image resampling and
sRGB conversion, zstd, and the host library they build."""
