"""Static invariant checker, race detector and schedule explorer of
openr_tpu_torch.

Port of `openr_tpu.analysis`, less its JAX-specific families (the jaxpr
and XLA-program audits, which have no counterpart here).  Two AST checker
families — thread discipline and counter hygiene — are stdlib-ast only;
`race` is the OPENR_TSAN happens-before detector and `sched` the
OPENR_SCHED schedule explorer.  The configuration is the package's own
`analysis.toml`.  Run with ``python -m openr_tpu_torch.analysis
openr_tpu_torch/``.
"""

from .core import (  # noqa: F401
    ALL_RULES,
    AnalysisConfig,
    AnalysisError,
    Finding,
    Reporter,
    Severity,
    load_config,
    read_config,
    run_analysis,
)
