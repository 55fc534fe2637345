"""Path, config, checkpoint and profiling helpers (JAX's exports)."""

from bert4rec_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from bert4rec_tpu_torch.utils.profiling import StepTimer, hard_sync, trace
from bert4rec_tpu_torch.utils.utils import (
    get_data_dir,
    get_default_model_save_path,
    get_project_root,
    get_virtual_env_path,
    load_json_config,
)

__all__ = [
    "get_project_root",
    "get_virtual_env_path",
    "get_data_dir",
    "get_default_model_save_path",
    "load_json_config",
    "load_pytree",
    "save_pytree",
    "StepTimer",
    "hard_sync",
    "trace",
]
