"""The port's Reddit training example
(``bert4rec_tpu_torch/examples/bert4rec_reddit_example.py``) end to end on
the CPU, as ``test_torch_example_datasets.py`` runs the others, on a
``tools/synth_corpus.py --small`` Reddit dump: a file of its own, the
slowest flow on the CPU (6 train steps of S=200)."""

from test_torch_example_datasets import train_and_check


def test_training_example_reddit(tmp_path):
    train_and_check("reddit", tmp_path)
