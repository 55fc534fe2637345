"""Judge the program's next-item training batches against the corpus.

A batch row of the ``next_item`` task is sound when it is one user's
history window of ``L`` items with the last one taken out of the input:
the first ``n = L - 1`` positions real (``input_mask``), the rest padding
0; ``k = min(P, n)`` predicted positions, ``n - k .. n - 1`` in order,
each labelled with the item that follows it (the last with the item taken
out); positions and labels 0 past ``k``; and the window, the taken item put
back, a run of consecutive items of one user (the whole history where it
is shorter than the sequence, else any ``S``-long run). Returns the
matched users, so a caller can check that rows differ.
"""

import numpy as np

from benchmark.reference.judge import K


def judge_batch(corpus, batch: dict, masking: dict) -> tuple:
    """(problems, users) of one host batch of numpy arrays."""
    ids = batch["input_word_ids"].astype(np.int64)
    mask = batch["input_mask"]
    pos = batch["masked_lm_positions"].astype(np.int64)
    lab = batch["masked_lm_ids"].astype(np.int64)
    s, p = masking["max_seq_len"], masking["max_predictions_per_seq"]
    problems, users = [], []
    for r in range(ids.shape[0]):
        n = int(mask[r].sum())
        k = min(p, n)
        where = f"row {r}"
        if not np.array_equal(mask[r], (np.arange(s) < n).astype(mask.dtype)):
            problems.append(f"{where}: input_mask is not a prefix")
        if np.any(ids[r, n:] != masking["pad_token_id"]):
            problems.append(f"{where}: padding holds items")
        if (k < 1 or not np.array_equal(pos[r, :k], np.arange(n - k, n))
                or np.any(pos[r, k:] != 0) or np.any(lab[r, k:] != 0)
                or not np.array_equal(lab[r, :k - 1], ids[r, pos[r, :k - 1]
                                                         + 1])):
            problems.append(f"{where}: the predicted positions break the "
                            f"next-item law")
            users.append(-1)
            continue
        window = np.concatenate([ids[r, :n], lab[r, k - 1:k]])
        user = corpus.find(window, full=n + 1 < s) if n + 1 >= K else -1
        if user < 0:
            problems.append(f"{where}: no user holds this window")
        users.append(user)
    return problems, users
