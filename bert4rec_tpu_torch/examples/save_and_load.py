"""Save / load round trip and a resumed training run (port of
``examples/bert4rec_save_and_load_example.py``).

``BERT4RecModelWrapper.save`` writes a directory of weights, configs and
the vocabulary, and ``load`` restores model, params and tokenizer; a
trainer's checkpoint holds the whole train state in the JAX trainer's
layout, and a second trainer resumes from it. Random weights and a
synthetic catalog, no download::

    python -m bert4rec_tpu_torch.examples.save_and_load [--device cpu]
"""

import argparse
import pathlib
import tempfile

import numpy as np
import torch

from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu_torch.models import (
    BERT4RecConfig, BERT4RecModel, BERT4RecModelWrapper,
)
from bert4rec_tpu_torch.trainers import BERT4RecTrainer
from bert4rec_tpu_torch.utils import checkpoint

SEQ, PRED = 16, 4


def main(device: str = "cuda") -> dict:
    dataloader = BERT4RecDataloader(max_seq_len=SEQ,
                                    max_predictions_per_seq=PRED)
    dataloader.generate_vocab([f"item_{i}" for i in range(40)])
    tokenizer = dataloader.get_tokenizer()
    vocab = tokenizer.get_vocab_size()
    config = BERT4RecConfig(vocab_size=vocab, hidden_size=32, num_layers=2,
                            num_attention_heads=4, inner_dim=64,
                            max_sequence_length=SEQ,
                            max_predictions_per_seq=PRED)
    model = BERT4RecModel(config=config)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    out = {}

    with tempfile.TemporaryDirectory() as td:
        save_path = pathlib.Path(td) / "bert4rec_demo"
        BERT4RecModelWrapper(model, params).save(save_path,
                                                 tokenizer=tokenizer, mode=2)
        print("saved artifacts:", sorted(p.name for p in save_path.iterdir()))
        restored, extras = BERT4RecModelWrapper.load(save_path, mode=2,
                                                     device=device)
        print("restored model config ==", restored.model.config == config)
        print("restored tokenizer vocab size:",
              extras["tokenizer"].get_vocab_size())
        batch = {"input_word_ids": torch.full((1, SEQ), 5, dtype=torch.int32),
                 "input_mask": torch.ones((1, SEQ), dtype=torch.int32),
                 "masked_lm_positions": torch.tensor([[3]],
                                                     dtype=torch.int32)}
        batch = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            a = model.apply(params, batch)["mlm_logits"]
            b = restored.model.apply(restored.params, batch)["mlm_logits"]
        out["identical_outputs"] = bool(torch.equal(a, b))
        print("identical outputs:", out["identical_outputs"])

        # the train state: two epochs, checkpointed; a fresh trainer
        # resumes from the file and runs a third
        rng = np.random.default_rng(0)
        seqs = [rng.integers(3, vocab, int(n)).astype(np.int32)
                for n in rng.integers(4, SEQ, 64)]
        train = ProcessedDataset(seqs, MaskingConfig(
            max_seq_len=SEQ, max_predictions_per_seq=PRED, mask_token_id=1,
            pad_token_id=0, unk_token_id=2, masked_lm_rate=0.3),
            lambda: vocab)
        ckpt = pathlib.Path(td) / "train_state.npz"
        first = BERT4RecTrainer(model)
        first.initialize_model(params=params, seed=7, device=device)
        first.train(train, epochs=2, batch_size=16, steps_per_epoch=2,
                    verbose=False)
        first.save_checkpoint(ckpt)
        stored = checkpoint.load_npz(ckpt)
        print("checkpoint layout:", sorted(k for k in stored
                                            if not k.startswith(
                                                ("params/", "opt_state/"))),
              "+ params/... + opt_state/1/0/{count,mu,nu}, "
              "opt_state/1/2/count")
        second = BERT4RecTrainer(model)
        second.initialize_model(params=params, seed=0, device=device)
        history = second.train(train, checkpoint_path=ckpt, epochs=3,
                               batch_size=16, steps_per_epoch=2,
                               verbose=False)
        out["resumed_step"] = second.state["step"]
        out["resumed_seed"] = second.state["seed"]
        print(f"resumed at epoch 3: step {out['resumed_step']}, seed "
              f"{out['resumed_seed']}, loss {history.history['loss'][-1]:.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
