"""PyTorch/CUDA port of ``pmhc_tpu`` for NVIDIA Hopper (H100).

The JAX package ``pmhc_tpu`` stays the reference; this package imports
neither it nor JAX. Public layout is the JAX package's ``[B, N, C]``.
Entry points run on the card unless the caller passes ``device="cpu"``
(the CPU tests do); on CPU tensors every kernel wrapper takes its plain
PyTorch version.

The serving path: ``pmhc_tpu_torch.serve.SamplerService`` ->
``diffusion.sampler.sample`` -> the fused EGNN layer kernel
(``ops/egnn_fused.py``, ``csrc/egnn_fused.cu``) -> atom14 -> PDB bytes,
behind the HTTP server ``cli/serve_cli.py``. The training step:
``train.Trainer`` with the neighbour-loop kernels (``ops/egnn_loop.py``).
The offline entry points: ``data`` (SwiftMHC HDF5 or its packed ``.npz``)
-> ``cli/train_cli.py`` and ``cli/sample_cli.py``.
"""
