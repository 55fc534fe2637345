"""Plain float32 PyTorch reference of BERT4Rec training, written from the
model's description (BERT4Rec, arXiv:1904.06690; the reference encoder's
post-LN BERT block) and the laws the configuration states. It imports
nothing of ``bert4rec_tpu_torch``, ``bert4rec_tpu`` or ``jax``, and takes
no tensor the program made: the benchmark hands it the weights it made
itself, and it judges the program's masked batches against the corpus
before it trains on them."""
