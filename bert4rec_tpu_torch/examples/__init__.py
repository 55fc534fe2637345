"""User flows of the port, runnable with ``python -m
bert4rec_tpu_torch.examples.<name>``, one module per script of the JAX
package's ``examples/`` under its name (``ranker_app``, ``save_and_load``
and ``serving_export`` for JAX's ``ranker_app_example``,
``bert4rec_save_and_load_example`` and ``serving_export_example``). Each
runs on the card by default and on the CPU with ``--device cpu``; the
JAX script's positional arguments come first.

Training on a dataset on disk (under ``BERT4REC_TPU_HOME``; nothing is
downloaded without it), train -> evaluate -> save through ``_common``:
``bert4rec_ml_1m_example``, ``bert4rec_beauty_example``,
``bert4rec_steam_example``, ``bert4rec_ml_20m_example``,
``bert4rec_reddit_example``. ``BERT4REC_TPU_EXAMPLE_EPOCHS`` cuts their
150 epochs, ``BERT4REC_TPU_LOAD_N_RECORDS`` their records.

Over a saved ML-1M model (``[SAVE_PATH]``, default
``bert4rec_ml-1m_128``): ``bert4rec_evaluation_example``,
``recommender_app_example``, ``ranker_app``, ``serving_server_example``
(``SAVE_PATH PORT demo`` serves one request and one ``/healthz`` call).

Self-contained: ``bert4rec_lifecycle_example`` (build -> train -> evaluate
-> save -> load -> recommend), ``loss_calculation_example``,
``temporal_features_example``, ``sasrec_example``, ``save_and_load``,
``serving_export``, ``multihost_example`` and ``sharded_ranking_example``
(ranks of their own); ``dataloader_usage_example`` reads the ML-1M corpus
on disk."""
