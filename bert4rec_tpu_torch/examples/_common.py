"""Shared scaffolding for the example scripts (port of
``examples/_common.py``).

The per-dataset training examples differ only in dataloader + config name +
a few hyperparameters (mirroring the reference's examples/, e.g.
bert4rec_ml_1m_example.py:14-95); this module holds the one shared flow,
the demo-title fallback of the app examples, and the command line every
example shares: the JAX script's positional arguments and ``--device``
(default ``cuda``; without CUDA the flows raise unless ``--device cpu``).
"""

import argparse
import os
import pathlib

from bert4rec_tpu_torch import config as config_pkg
from bert4rec_tpu_torch import trainers
from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
from bert4rec_tpu_torch.models import (
    BERT4RecModel, BERT4RecModelWrapper, model_utils,
)
from bert4rec_tpu_torch.trainers.callbacks import EarlyStopping


def command_line(doc: str, argv=None, **positional) -> dict:
    """Parse ``argv``: the JAX script's optional positional arguments (name
    -> default, in order) and ``--device``."""
    parser = argparse.ArgumentParser(description=doc.split("\n")[0])
    for name, default in positional.items():
        parser.add_argument(name, nargs="?", default=default)
    parser.add_argument("--device", default="cuda")
    return vars(parser.parse_args(argv))


def card_config(config, device):
    """On the card, the fused layer and the fused tied-softmax loss (the
    hand-written kernels); on the CPU the config as it is (the plain
    path)."""
    if resolve_device(device).type == "cuda":
        return config.replace(use_fused_layer=True, use_fused_loss=True)
    return config


def run_training_example(dataset: str,
                         encoder_config: str,
                         epochs: int = 150,
                         batch_size: int = 256,
                         input_duplication_factor: int = 5,
                         finetuning_split: float = 0.1,
                         early_stopping_patience: int = 20,
                         save_name: str = None,
                         dataloader_kwargs: dict = None,
                         seed: int = 42,
                         device="cuda"):
    """Full train -> evaluate -> save flow for one dataset; returns
    ``(wrapper, metrics, history)``."""
    device = resolve_device(device)
    # smoke knob: the tests and chip_smoke run these scripts end to end on
    # a synthetic corpus (tools/synth_corpus.py + BERT4REC_TPU_HOME) with a
    # short epoch budget; the default remains the reference's full run
    env_epochs = os.environ.get("BERT4REC_TPU_EXAMPLE_EPOCHS")
    if env_epochs:
        epochs = int(env_epochs)
    factory = get_dataloader_factory("bert4rec")
    create = getattr(factory, f"create_{dataset}_dataloader")
    dataloader = create(input_duplication_factor=input_duplication_factor,
                        **(dataloader_kwargs or {}))

    train_ds, val_ds, test_ds = dataloader.prepare_training(
        finetuning_split=finetuning_split)
    tokenizer = dataloader.get_tokenizer()

    config = card_config(config_pkg.load_train_config(
        encoder_config, vocab_size=tokenizer.get_vocab_size()), device)
    model = BERT4RecModel(config=config)
    wrapper = BERT4RecModelWrapper(model)

    # on the card 4 steps a call (the JAX trainer's steps_per_call; the
    # same math as one step a call)
    trainer = trainers.get("bert4rec", model=model,
                           steps_per_call=4 if device.type == "cuda" else 1)
    trainer.initialize_model(seed=seed, device=device)
    trainer.append_callback(EarlyStopping(monitor="val_loss",
                                          patience=early_stopping_patience))

    save_path = model_utils.determine_model_path(
        pathlib.Path(save_name or f"bert4rec_{dataset}"))
    checkpoint_path = save_path / "checkpoints" / "best.npz"

    wrapper.update_meta({
        "EPOCHS": epochs,
        "input_duplication_factor": input_duplication_factor,
        "finetuning_split": finetuning_split,
        "early_stopping_patience": early_stopping_patience,
    })

    history = trainer.train(train_ds, val_ds,
                            checkpoint_path=checkpoint_path, epochs=epochs,
                            batch_size=batch_size, seed=seed)
    trainer.update_wrapper_meta_info(wrapper, dataloader)
    wrapper.update_params(trainer.params)

    evaluator = BERT4RecEvaluator(dataloader=dataloader)
    metrics = evaluator.evaluate(model, trainer.params, test_ds,
                                 batch_size=batch_size)
    evaluator.save_results(save_path)
    print(metrics)

    wrapper.save(save_path=save_path, tokenizer=tokenizer, mode=2)
    return wrapper, metrics, history


def fallback_titles(extras, *groups):
    """Replace the demo title groups with slices of the model's own
    catalog when any default title is unknown to its tokenizer (models
    trained on another corpus — e.g. the synthetic offline one — have a
    different catalog). Shared by the recommender/ranker app examples so
    the fallback logic cannot drift between them."""
    known = set(extras["tokenizer"].get_vocab()) \
        if "tokenizer" in extras else set()
    if not known or all(t in known for g in groups for t in g):
        return groups if len(groups) > 1 else groups[0]
    titles = sorted(known - {"[PAD]", "[MASK]", "[UNK]"})
    need = sum(len(g) for g in groups)
    if len(titles) < need:
        raise SystemExit(
            f"this model's catalog has only {len(titles)} usable titles; "
            f"the demo needs {need} — train on a larger corpus first")
    print("(default titles not in this model's vocab; using its own)")
    out, i = [], 0
    for g in groups:
        out.append(titles[i:i + len(g)])
        i += len(g)
    return out if len(out) > 1 else out[0]
