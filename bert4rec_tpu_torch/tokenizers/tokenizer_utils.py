"""Numeric vocab file helpers (port of
``bert4rec_tpu/tokenizers/tokenizer_utils.py``)."""

import pathlib


def export_num_vocab_to_file(file_path: pathlib.Path, vocab: list) -> bool:
    """Write one vocab entry per line."""
    with open(file_path, "w", encoding="utf-8") as f:
        for entry in vocab:
            f.write(f"{entry}\n")
    return True


def import_num_vocab_from_file(file_path: pathlib.Path) -> list:
    """Read one numeric vocab entry per line."""
    file_path = pathlib.Path(file_path)
    if not file_path.is_file():
        raise RuntimeError(f"The vocab file does not exist at {file_path}.")
    vocab = []
    with open(file_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                vocab.append(int(line))
    return vocab
