"""Each kernel's work from shapes (`<kernel>.py`) and its CUDA kernels'
names (`<kernel>.json`)."""
