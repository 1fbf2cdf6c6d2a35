"""Static invariant checker, race detector and schedule explorer of
openr_tpu_torch.

Port of `openr_tpu.analysis`.  Three AST checker families — dispatch
hygiene (the reference's jit rules, `dispatch`), thread discipline and
counter hygiene — are stdlib-ast only; the program auditor (`programs`,
``--programs``) runs the device roots under a recording dispatch mode;
`race` is the OPENR_TSAN happens-before detector and `sched` the
OPENR_SCHED schedule explorer.  The configuration is the package's own
`analysis.toml`.  Run with ``python -m openr_tpu_torch.analysis
openr_tpu_torch/`` (add ``--programs`` for the auditor).
"""

from .core import (  # noqa: F401
    ALL_RULES,
    PROGRAM_RULES,
    AnalysisConfig,
    AnalysisError,
    Finding,
    Reporter,
    Severity,
    load_config,
    read_config,
    run_analysis,
)
