"""Device compute kernels: edit-distance table generation, frame diffing,
quantization/dithering, audio resampling."""
