"""Path and config helpers (port of ``bert4rec_tpu/utils/utils.py``): data
and model paths are anchored at the project root, overridable with
``BERT4REC_TPU_HOME``."""

import json
import os
import pathlib


def get_project_root() -> pathlib.Path:
    env = os.environ.get("BERT4REC_TPU_HOME")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parent.parent.parent


def get_virtual_env_path() -> pathlib.Path:
    env = os.environ.get("VIRTUAL_ENV")
    if env:
        return pathlib.Path(env)
    return get_project_root()


def get_data_dir() -> pathlib.Path:
    return get_project_root() / "data"


def get_default_model_save_path() -> pathlib.Path:
    return get_project_root() / "saved_models"


def load_json_config(path: pathlib.Path) -> dict:
    """A JSON config file as a dict."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Config file {path} does not exist.")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
