"""PyTorch/CUDA port of openr_tpu: the route computation and, around it,
the node's modules and the daemon (`main.OpenrDaemon`, `python -m
openr_tpu_torch.main`) with its ctrl server and breeze CLI.

Mirrors the layout of `openr_tpu` (decision/, ops/, device/, kvstore/,
ctrl/, cli/, ...) so each module's counterpart is easy to find.  Imports torch and numpy,
never jax and never openr_tpu.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""
