"""breeze: the operator CLI (port of `openr_tpu.cli`; reference:
openr/py/openr/cli/breeze.py)."""
