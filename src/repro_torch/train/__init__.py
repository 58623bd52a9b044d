"""Training of the port: step (on one device or data-parallel over a mesh),
optimizer (AdamW, ZeRO-1 specs and update), gradient sync, checkpoints (in a
directory or through HoardFS, elastic across meshes), fault tolerance.
"""

from .checkpoint import CheckpointManager, SamplerState, config_digest
from .fault import PreemptionGuard, RestartPolicy, StragglerMonitor, run_with_restarts
from .hoardckpt import HoardCheckpointManager
from .optimizer import (AdamWConfig, adamw_update, compress_int8, decompress_int8,
                        gather_params, init_opt_state, init_zero_state, opt_state_specs,
                        zero_shardings, zero_spec_for, zero_update_shards)
from .step import (DataParallelStep, init_train_state, make_eval_step, make_train_step,
                   token_batch_from_bytes)
from .sync import init_error_state, two_level_grad_sync

__all__ = [
    "AdamWConfig", "CheckpointManager", "DataParallelStep", "HoardCheckpointManager",
    "PreemptionGuard", "RestartPolicy", "SamplerState", "StragglerMonitor", "adamw_update",
    "compress_int8", "config_digest", "decompress_int8", "gather_params", "init_error_state",
    "init_opt_state", "init_train_state", "init_zero_state", "make_eval_step",
    "make_train_step", "opt_state_specs", "run_with_restarts", "token_batch_from_bytes",
    "two_level_grad_sync", "zero_shardings", "zero_spec_for", "zero_update_shards",
]
