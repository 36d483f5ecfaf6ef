"""Device kernels of the port: the GF(2^8) matrix product (gf256) in CUDA
C++ for sm_90a, its plain PyTorch version, and the codec built on it."""
