"""Judge the program's masked training batches against the corpus.

A batch row is sound when it is one user's history window with the
masking law applied: the first ``L`` positions real (``input_mask``), the
rest padding 0; ``min(P, max(1, floor(L * rate)))`` positions chosen,
ascending, each holding the mask token in the input and the original item
as its label; labels and positions 0 past the count; and the window, with
the labels put back, a run of consecutive items of one user (the whole
history where it is shorter than the sequence, else any ``S``-long run).
Returns the matched users, so a caller can check that rows differ.
"""

import numpy as np
import torch

K = 4   # items per key of the window index


def _keys(t: torch.Tensor) -> torch.Tensor:
    h = torch.zeros(t.shape[-1] - K + 1, dtype=torch.int64, device=t.device)
    for j in range(K):
        h = h * 1000003 + t[j:t.shape[-1] - K + 1 + j]
    return h


class Corpus:
    def __init__(self, sequences, device):
        lengths = np.array([len(s) for s in sequences], dtype=np.int64)
        self.lengths = lengths
        self.offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        self.flat = torch.from_numpy(np.concatenate(sequences).astype(
            np.int64)).to(device)
        keys = _keys(self.flat)
        self.sorted_keys, self.order = torch.sort(keys)
        self.flat_np = self.flat.cpu().numpy()
        self.sorted_keys = self.sorted_keys.cpu()
        self.order = self.order.cpu().numpy()

    def find(self, window: np.ndarray, full: bool) -> int:
        """The user whose history holds ``window`` (as a whole history
        when ``full``), or -1."""
        key = _keys(torch.from_numpy(window[:K].astype(np.int64)))[0]
        lo = int(torch.searchsorted(self.sorted_keys, key))
        hi = int(torch.searchsorted(self.sorted_keys, key, right=True))
        n = len(window)
        for start in self.order[lo:hi]:
            user = int(np.searchsorted(self.offsets, start, side="right")) - 1
            off, length = self.offsets[user], self.lengths[user]
            if start + n > off + length:
                continue
            if full and (start != off or length != n):
                continue
            if np.array_equal(self.flat_np[start:start + n], window):
                return user
        return -1


def judge_batch(corpus: Corpus, batch: dict, masking: dict) -> tuple:
    """(problems, users) of one host batch of numpy arrays."""
    ids = batch["input_word_ids"].astype(np.int64)
    mask = batch["input_mask"]
    pos = batch["masked_lm_positions"].astype(np.int64)
    lab = batch["masked_lm_ids"].astype(np.int64)
    s, p = masking["max_seq_len"], masking["max_predictions_per_seq"]
    problems, users = [], []
    for r in range(ids.shape[0]):
        n = int(mask[r].sum())
        count = min(p, max(1, int(np.float64(n) * masking["masked_lm_rate"])))
        where = f"row {r}"
        if not np.array_equal(mask[r], (np.arange(s) < n).astype(mask.dtype)):
            problems.append(f"{where}: input_mask is not a prefix")
        if np.any(ids[r, n:] != masking["pad_token_id"]):
            problems.append(f"{where}: padding holds items")
        chosen = pos[r, :count]
        if (np.any(np.diff(chosen) <= 0) or chosen.min() < 0
                or chosen.max() >= n or np.any(pos[r, count:] != 0)
                or np.any(lab[r, count:] != 0)):
            problems.append(f"{where}: masked positions break the law")
            users.append(-1)
            continue
        if np.any(ids[r, chosen] != masking["mask_token_id"]):
            problems.append(f"{where}: a chosen position is not masked")
        window = ids[r, :n].copy()
        window[chosen] = lab[r, :count]
        user = corpus.find(window, full=n < s) if n >= K else -1
        if user < 0:
            problems.append(f"{where}: no user holds this window")
        users.append(user)
    return problems, users
