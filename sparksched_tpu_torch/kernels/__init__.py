"""Hand-written Hopper kernels of the port and their plain PyTorch
versions. Sources live in `../csrc/`; `build.py` compiles them with
nvcc for sm_90a at first use and loads them with ctypes."""
