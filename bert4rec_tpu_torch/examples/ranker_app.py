"""Ranker app usage (port of ``examples/ranker_app_example.py``): rank a
target item, or a list of candidates, for a history.

With a saved model (``--model PATH``, or JAX's positional ``save_path``)
it loads it (``BERT4RecModelWrapper``, with its tokenizer) behind the
ML-1M dataloader and ranks JAX's demo titles, or, where the model's
catalog lacks them, titles of its own (``_common.fallback_titles``);
without one, a model with random weights over a synthetic catalog stands
in::

    python -m bert4rec_tpu_torch.examples.ranker_app [SAVE_PATH] \\
        [--model PATH] [--device cpu]
"""

import argparse

import torch

from bert4rec_tpu_torch.apps import Ranker
from bert4rec_tpu_torch.dataloaders import (
    BERT4RecDataloader, get_dataloader_factory,
)
from bert4rec_tpu_torch.examples._common import fallback_titles
from bert4rec_tpu_torch.models import (
    BERT4RecConfig, BERT4RecModel, BERT4RecModelWrapper,
)

SEQ, PRED = 32, 8


def main(model_path=None, device: str = "cuda") -> dict:
    if model_path is not None:
        wrapper, extras = BERT4RecModelWrapper.load(model_path, device=device)
        model, params = wrapper.model, wrapper.params
        dataloader = get_dataloader_factory(
            "bert4rec").create_ml_1m_dataloader(
                tokenizer=extras.get("tokenizer"))
        history = [
            "Toy Story (1995)",
            "Aladdin (1992)",
            "Lion King, The (1994)",
        ]
        candidates = ["Toy Story 2 (1999)", "GoldenEye (1995)",
                      "Casino (1995)"]
        history, candidates = fallback_titles(extras, history, candidates)
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
        history, candidates = titles[:3], titles[10:13]

    ranker = Ranker(model, params, dataloader, device=device)
    rank, text = ranker(history, rank_item=candidates[0])
    print(text)
    ranking = ranker(history, rank_items=candidates)
    print(ranking)
    return {"rank": rank, "ranking": ranking}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("save_path", nargs="?", default=None)
    parser.add_argument("--model", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.model or args.save_path, args.device)
