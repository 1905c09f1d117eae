"""The port's kernels. Each op has its plain PyTorch version in
``<op>/ref.py`` and its CUDA wrapper in the module named after the op; the
CUDA sources are ``src/repro_torch/csrc/*.cu``, built by
`repro_torch.kernels.cuda` at first launch."""
