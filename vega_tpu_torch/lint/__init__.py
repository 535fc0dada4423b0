"""vegalint for the port: the project's invariant linter and its runtime
lock-order witness, over vega_tpu_torch's own layout.

Each written invariant of the runtime (lock order, no device probe on an
import path, no host sync inside device functions, pure placement and
frame-plan reads, bounded socket waits, the protocol / knob / event
contracts, the exchange contract, the streaming commit API, the
thread-role call graph) is a machine-checked rule:

    python -m vega_tpu_torch.lint vega_tpu_torch chip_smoke.py

Rule catalog: ``python -m vega_tpu_torch.lint --list-rules``. Every rule
of vega_tpu's vegalint has its counterpart here except VG001, which
guards a jax compatibility shim the port does not have.
Runtime companion: ``vega_tpu_torch.lint.sync_witness`` — under
``VEGA_TPU_DEBUG_SYNC=1`` the named locks record their acquisition order
per thread and raise on inversion, so VG003's static lock-order graph is
double-checked dynamically by every run that sets the flag.

This package imports only the stdlib: sync_witness is imported at lock
construction time by core modules, and the CLI lints a tree it never
imports.
"""

from vega_tpu_torch.lint.engine import Finding, LintResult, all_rules, run_lint

__all__ = ["Finding", "LintResult", "all_rules", "run_lint"]
