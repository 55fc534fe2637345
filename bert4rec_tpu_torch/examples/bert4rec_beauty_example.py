"""End-to-end training example on Amazon Beauty (port of
``examples/bert4rec_beauty_example.py``).

Trains on the dataset on disk (under ``BERT4REC_TPU_HOME``), evaluates,
and saves the model under ``saved_models/bert4rec_beauty_128``::

    python -m bert4rec_tpu_torch.examples.bert4rec_beauty_example \\
        [--device cpu]
"""

from bert4rec_tpu_torch.examples._common import (
    command_line, run_training_example,
)


def main(device="cuda"):
    return run_training_example(
        dataset="beauty",
        encoder_config="beauty_128",
        epochs=150,
        batch_size=256,
        input_duplication_factor=5,
        finetuning_split=0.1,
        save_name="bert4rec_beauty_128",
        device=device,
    )


if __name__ == "__main__":
    main(**command_line(__doc__))
