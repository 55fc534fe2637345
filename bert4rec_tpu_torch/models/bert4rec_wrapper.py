"""BERT4Rec persistence wrapper (port of
``bert4rec_tpu/models/bert4rec_wrapper.py``).

The artifact directory is the JAX package's, file for file, so an artifact
saved by either package loads in the other:

- ``weights.npz``          — the full param dict, path-keyed
- ``encoder_config.json``  — :class:`BERT4RecConfig`
- ``meta_config.json``     — admin metadata incl. the tokenizer identifier
- ``vocab.txt``            — tokenizer vocab (``key|id`` lines)
"""

import json
import pathlib
from typing import Optional, Union

from bert4rec_tpu_torch import tokenizers
from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.models import model_utils
from bert4rec_tpu_torch.models.bert4rec_model import BERT4RecModel
from bert4rec_tpu_torch.models.config import BERT4RecConfig
from bert4rec_tpu_torch.models.model_wrapper import ModelWrapper
from bert4rec_tpu_torch.utils import checkpoint

WEIGHTS_FILE = "weights.npz"
ENCODER_CONFIG_FILE = "encoder_config.json"
META_CONFIG_FILE = "meta_config.json"
VOCAB_FILE = "vocab.txt"


class BERT4RecModelWrapper(ModelWrapper):

    def __init__(self, model: BERT4RecModel, params: Optional[dict] = None):
        super().__init__(model)
        self.params = params

    def update_params(self, params: dict) -> None:
        self.params = params

    def save(self, save_path: Union[str, pathlib.Path],
             tokenizer: Optional[tokenizers.BaseTokenizer] = None,
             mode: int = 0) -> pathlib.Path:
        if self.params is None:
            raise RuntimeError(
                "The model can't be saved yet: no parameters attached. "
                "Attach initialized or loaded params first.")
        save_path = model_utils.determine_model_path(save_path, mode)
        save_path.mkdir(parents=True, exist_ok=True)
        checkpoint.save_pytree(save_path / WEIGHTS_FILE, self.params)
        if tokenizer is not None:
            self.update_meta({"tokenizer": tokenizer.identifier})
        with open(save_path / ENCODER_CONFIG_FILE, "w") as f:
            json.dump(self.model.get_config(), f, indent=2)
        if tokenizer is not None:
            tokenizer.export_vocab_to_file(save_path / VOCAB_FILE)
        with open(save_path / META_CONFIG_FILE, "w") as f:
            json.dump(self._meta_config, f, indent=2)
        return save_path

    @classmethod
    def load(cls, save_path: Union[str, pathlib.Path], mode: int = 0,
             device="cuda") -> tuple:
        """Restore ``(wrapper, extras)`` with the params on ``device``;
        extras may hold ``tokenizer``. The model serves in fp32, as the
        JAX package's ``load`` builds it with no dtype policy."""
        device = resolve_device(device)
        save_path = model_utils.determine_model_path(save_path, mode)
        if not save_path.is_dir():
            raise FileNotFoundError(f"No saved model at {save_path}")

        with open(save_path / ENCODER_CONFIG_FILE) as f:
            config = BERT4RecConfig.from_dict(json.load(f))
        model = BERT4RecModel(config=config)

        flat = checkpoint.load_npz(save_path / WEIGHTS_FILE)
        # like-structured shapes-only target, as JAX's eval_shape(init)
        target = model.init(device="meta")
        checkpoint.check_structure(flat, target,
                                   source=str(save_path / WEIGHTS_FILE))
        params = checkpoint.params_from_numpy(
            {k: flat[k] for k in checkpoint.flatten(target)}, device)

        wrapper = cls(model, params)
        extras = {}
        meta_path = save_path / META_CONFIG_FILE
        if meta_path.is_file():
            with open(meta_path) as f:
                wrapper._meta_config = json.load(f)
            identifier = wrapper._meta_config.get("tokenizer")
            vocab_path = save_path / VOCAB_FILE
            if identifier and vocab_path.is_file():
                tokenizer = tokenizers.get(identifier)
                tokenizer.import_vocab_from_file(vocab_path)
                extras["tokenizer"] = tokenizer
        return wrapper, extras
