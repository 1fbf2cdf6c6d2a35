"""PyTorch/CUDA port of openr_tpu's route computation.

Mirrors the layout of `openr_tpu` (decision/, ops/, device/, utils/) so
each module's counterpart is easy to find.  Imports torch and numpy,
never jax and never openr_tpu.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""
