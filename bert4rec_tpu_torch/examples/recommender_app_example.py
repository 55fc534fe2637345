"""Recommender app usage (port of ``examples/recommender_app_example.py``;
reference examples/recommender_app_example.py): load a saved ML-1M model
and recommend the next movie for a history::

    python -m bert4rec_tpu_torch.examples.recommender_app_example \\
        [SAVE_PATH] [--device cpu]
"""

import pathlib

from bert4rec_tpu_torch.apps import Recommender
from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
from bert4rec_tpu_torch.examples._common import command_line, fallback_titles
from bert4rec_tpu_torch.models import BERT4RecModelWrapper


def main(save_path: str = "bert4rec_ml-1m_128", device="cuda") -> dict:
    wrapper, extras = BERT4RecModelWrapper.load(pathlib.Path(save_path),
                                                device=device)
    dataloader = get_dataloader_factory("bert4rec").create_ml_1m_dataloader(
        tokenizer=extras.get("tokenizer"))

    recommender = Recommender(wrapper.model, wrapper.params, dataloader,
                              device=device)
    history = [
        "Toy Story (1995)",
        "Aladdin (1992)",
        "Lion King, The (1994)",
    ]
    history = fallback_titles(extras, history)
    print("history:", history)
    recommendation = recommender(history)
    print("recommendation:", recommendation)
    return {"history": history, "recommendation": recommendation}


if __name__ == "__main__":
    main(**command_line(__doc__, save_path="bert4rec_ml-1m_128"))
