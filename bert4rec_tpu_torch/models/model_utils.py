"""Model utilities (port of ``determine_model_path`` in
``bert4rec_tpu/models/model_utils.py``)."""

import pathlib
from typing import Union

from bert4rec_tpu_torch.utils import utils


def determine_model_path(path: Union[str, pathlib.Path],
                         mode: int = 0) -> pathlib.Path:
    """Resolve a model save path: an absolute path as given; otherwise
    mode 0 -> under the default model save dir, mode 1 -> under the
    environment base dir, mode 2 -> as given."""
    path = pathlib.Path(path)
    if path.is_absolute():
        return path
    if mode == 0:
        return utils.get_default_model_save_path() / path
    if mode == 1:
        return utils.get_virtual_env_path() / path
    if mode == 2:
        return path
    raise ValueError(f"Unknown path mode: {mode}")
