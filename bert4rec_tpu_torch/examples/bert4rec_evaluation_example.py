"""Standalone evaluation of a saved model (port of
``examples/bert4rec_evaluation_example.py``; reference
examples/bert4rec_evaluation_example.py): load wrapper -> rebuild
dataloader -> sampled-negative HR/NDCG/MAP on the test split, written to
``<save_path>/eval_results.json``::

    python -m bert4rec_tpu_torch.examples.bert4rec_evaluation_example \\
        [SAVE_PATH] [--device cpu]
"""

import pathlib

from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
from bert4rec_tpu_torch.examples._common import command_line
from bert4rec_tpu_torch.models import BERT4RecModelWrapper


def main(save_path: str = "bert4rec_ml-1m_128", device="cuda") -> dict:
    wrapper, extras = BERT4RecModelWrapper.load(pathlib.Path(save_path),
                                                device=device)
    tokenizer = extras.get("tokenizer")

    factory = get_dataloader_factory("bert4rec")
    dataloader = factory.create_ml_1m_dataloader(tokenizer=tokenizer)
    if tokenizer is None:
        dataloader.generate_vocab()
    _, _, test_ds = dataloader.prepare_training(finetuning_split=0.1)

    evaluator = BERT4RecEvaluator(dataloader=dataloader)
    metrics = evaluator.evaluate(wrapper, test_ds=test_ds)
    print(metrics)
    evaluator.save_results(pathlib.Path(save_path))
    return metrics


if __name__ == "__main__":
    main(**command_line(__doc__, save_path="bert4rec_ml-1m_128"))
