"""End-to-end training example on Reddit (port of
``examples/bert4rec_reddit_example.py``). The 335k-item vocab is the
one case where the vocab-sharded embedding/softmax pays: a mesh with
``model_parallelism > 1`` shards it (core/mesh.py,
``multihost_example``).

Trains on the dataset on disk (under ``BERT4REC_TPU_HOME``), evaluates,
and saves the model under ``saved_models/bert4rec_reddit_128``::

    python -m bert4rec_tpu_torch.examples.bert4rec_reddit_example \\
        [--device cpu]
"""

from bert4rec_tpu_torch.examples._common import (
    command_line, run_training_example,
)


def main(device="cuda"):
    return run_training_example(
        dataset="reddit",
        encoder_config="reddit_128",
        epochs=150,
        batch_size=256,
        input_duplication_factor=2,
        finetuning_split=0.1,
        save_name="bert4rec_reddit_128",
        device=device,
    )


if __name__ == "__main__":
    main(**command_line(__doc__))
