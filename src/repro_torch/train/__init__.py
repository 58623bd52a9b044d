"""Training of the port: step, optimizer, checkpoints (in a directory or
through HoardFS), fault tolerance.

``sync`` and the ZeRO specs (``zero_spec_for``, ``opt_state_specs``) wait
for the multi-device slice.
"""

from .checkpoint import CheckpointManager, SamplerState, config_digest
from .fault import PreemptionGuard, RestartPolicy, StragglerMonitor, run_with_restarts
from .hoardckpt import HoardCheckpointManager
from .optimizer import AdamWConfig, adamw_update, compress_int8, decompress_int8, init_opt_state
from .step import init_train_state, make_eval_step, make_train_step, token_batch_from_bytes

__all__ = [
    "AdamWConfig", "CheckpointManager", "HoardCheckpointManager", "PreemptionGuard",
    "RestartPolicy", "SamplerState", "StragglerMonitor", "adamw_update", "compress_int8",
    "config_digest", "decompress_int8",
    "init_opt_state", "init_train_state", "make_eval_step", "make_train_step",
    "run_with_restarts", "token_batch_from_bytes",
]
