"""Ranker app usage (port of ``examples/ranker_app_example.py``): rank a
target item, or a list of candidates, for a history.

With ``--model PATH`` it loads a saved model (``BERT4RecModelWrapper``,
with its tokenizer); without it, a model with random weights over a
synthetic catalog stands in::

    python -m bert4rec_tpu_torch.examples.ranker_app [--model PATH] \\
        [--device cpu]
"""

import argparse

import torch

from bert4rec_tpu_torch.apps import Ranker
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.models import (
    BERT4RecConfig, BERT4RecModel, BERT4RecModelWrapper,
)

SEQ, PRED = 32, 8


def main(model_path=None, device: str = "cuda") -> dict:
    if model_path is not None:
        wrapper, extras = BERT4RecModelWrapper.load(model_path, device=device)
        model, params = wrapper.model, wrapper.params
        cfg = model.config
        dataloader = BERT4RecDataloader(cfg.max_sequence_length,
                                        cfg.max_predictions_per_seq,
                                        tokenizer=extras["tokenizer"])
        titles = [t for t in dataloader.tokenizer.get_vocab()
                  if not t.startswith("[")]
    else:
        titles = [f"Synthetic Feature No. {i:05d}" for i in range(200)]
        dataloader = BERT4RecDataloader(SEQ, PRED)
        dataloader.generate_vocab(titles)
        model = BERT4RecModel(config=BERT4RecConfig(
            vocab_size=dataloader.tokenizer.get_vocab_size(),
            hidden_size=64, num_layers=2, num_attention_heads=4,
            inner_dim=256, max_sequence_length=SEQ,
            max_predictions_per_seq=PRED))
        params = model.init(torch.Generator().manual_seed(0), device=device)

    ranker = Ranker(model, params, dataloader, device=device)
    history, candidates = titles[:3], titles[10:13]
    rank, text = ranker(history, rank_item=candidates[0])
    print(text)
    ranking = ranker(history, rank_items=candidates)
    print(ranking)
    return {"rank": rank, "ranking": ranking}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.model, args.device)
