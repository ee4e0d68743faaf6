"""The package's CUDA sources built for the host, for the CPU tests only
(``tests/test_torch_cuda_host.py``); see ``cuda_runtime.h`` here.  No
entry point of the package imports this."""
