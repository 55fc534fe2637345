"""User flows of the port, runnable with ``python -m``: save and load a
model and resume its training (``save_and_load``), rank items for a
history (``ranker_app``), export a serving artifact and serve it
(``serving_export``). Each runs on the card by default and on the CPU with
``--device cpu``."""
