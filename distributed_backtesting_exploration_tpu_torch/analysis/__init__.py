"""dbxlint, dbxcert and dbxmc over the port: the reference's
``analysis/`` aimed at this package.

- **AST layer** (:mod:`.ast_rules`): *trace-time-env* (env reads reachable
  from a kernel's build, load or launch: the launch boundary of
  ``ops/_kernels.py`` and the ``dbx_*`` entry wrappers, the port's twin
  of the reference's jit/pallas roots), *import-time-config*
  (module-level env/IO capture), *blocking-call* (sleeps, subprocesses,
  the card's waits and future waits inside gRPC servicer handlers and the
  worker control loop), *obs-cardinality* (metric labels fed from
  unbounded runtime data), *journal-discipline* (journaled-state
  mutation before its journal append).
- **concurrency layer** (:mod:`.locks`): one whole-package lock model
  behind *lock-discipline*, *lock-order*, *atomicity* and
  *lock-blocking*. Its runtime twin, :mod:`.lockdep`, is the opt-in
  (``DBX_LOCKDEP=1``) instrumented-lock shim the dispatcher's
  ``_lockdep_report`` and its ``main`` read.
- **wire layer** (:mod:`.proto_rules`): *proto-drift* between
  ``rpc/backtesting.proto`` and the generated ``rpc/backtesting_pb2.py``.
- **traced-program layer** (:mod:`.dataflow`, the reference's jaxpr
  walker over torch programs recorded op by op): *kernel-hygiene*
  (:mod:`.fx_rules`: host round trips, the launch boundary's dtypes and
  layouts, non-f32 and default-dtype outputs, a source pass over
  ``csrc/``) and dbxcert (:mod:`.certify`: *substrate-contract*,
  *weak-type-provenance*, *digest-determinism* against the port's own
  ``numerics.torch.contract.json``).
- **dbxmc** (:mod:`.modelcheck` over :mod:`.schedules`): the interleaving
  and crash-point model checker over the port's journaled dispatcher
  (its ``JobQueue``, ``Journal``, ``WfqScheduler`` and ``PanelStore``, on
  each available substrate).

Nothing here imports jax or the JAX package.

CLI::

    python -m distributed_backtesting_exploration_tpu_torch.analysis.lint \
        [paths ...] [--format text|json] [--rules a,b] [--list-rules]
        [--certify [--update-contract]]
    python -m distributed_backtesting_exploration_tpu_torch.analysis.certify \
        [--update] [--format text|json]
    python -m \
        distributed_backtesting_exploration_tpu_torch.analysis.modelcheck \
        [--ops N] [--seed S] [--schedules K] \
        [--substrate auto|python|native|both] [--replay FILE]

Inline suppression (same line or the comment line directly above), only
with a justifying comment::

    x = os.environ.get("DBX_X")  # dbxlint: disable=trace-time-env -- <why>
"""

from .core import Finding, LintContext, all_rules, lint_path  # noqa: F401
