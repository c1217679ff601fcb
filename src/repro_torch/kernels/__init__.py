"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``kernels/mode.py`` picks the route from the tensor's device;
``kernels/build.py`` compiles the sources on first use)."""
