"""Walk through one train step's loss math on a tiny synthetic batch (port
of ``examples/loss_calculation_example.py``; reference
examples/loss_calculation_example.py): forward -> MLM logits -> masked
sparse categorical cross-entropy (pad label 0 excluded), then the same
numbers by hand::

    python -m bert4rec_tpu_torch.examples.loss_calculation_example \\
        [--device cpu]
"""

import numpy as np
import torch

from bert4rec_tpu_torch.examples._common import command_line
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.trainers import trainer_utils


@torch.inference_mode()
def main(device="cuda") -> dict:
    vocab_size, seq_len, n_pred = 50, 12, 3
    config = BERT4RecConfig(vocab_size=vocab_size, hidden_size=32,
                            num_layers=2, num_attention_heads=4, inner_dim=64,
                            max_sequence_length=seq_len,
                            max_predictions_per_seq=n_pred)
    model = BERT4RecModel(config=config)
    params = model.init(torch.Generator().manual_seed(0), device=device)

    rng = np.random.default_rng(0)
    ids = rng.integers(3, vocab_size, size=(2, seq_len)).astype(np.int32)
    positions = np.array([[1, 4, 7], [0, 3, 0]], dtype=np.int32)
    gt = np.take_along_axis(ids, positions, axis=1)
    gt[1, 2] = 0  # padded prediction slot: excluded from the loss
    batch = {
        "input_word_ids": ids,
        "input_mask": np.ones((2, seq_len), np.int32),
        "masked_lm_positions": positions,
    }

    outputs = model.apply(params, {k: torch.from_numpy(v).to(device)
                                   for k, v in batch.items()})
    logits = outputs["mlm_logits"]
    print("mlm_logits:", tuple(logits.shape))

    labels = torch.from_numpy(gt).to(logits.device)
    loss = float(trainer_utils.masked_sparse_categorical_crossentropy(
        labels, logits))
    acc = float(trainer_utils.masked_accuracy(labels, logits))
    print(f"masked SCCE loss = {loss:.4f} "
          f"(over {int((gt != 0).sum())} unmasked positions)")
    print(f"masked accuracy  = {acc:.4f}")

    # the same numbers by hand, on the host in float64
    z = logits.double().cpu().numpy()
    top = z.max(-1, keepdims=True)
    logp = z - top - np.log(np.exp(z - top).sum(-1, keepdims=True))
    mask = gt != 0
    nll = -np.take_along_axis(logp, gt[..., None], axis=-1)[..., 0]
    manual = float(nll[mask].mean())
    print(f"manual loss      = {manual:.4f}")
    print(f"manual - library = {manual - loss:.3e}")
    return {"loss": loss, "accuracy": acc, "manual_loss": manual,
            "logits": logits.cpu().numpy()}


if __name__ == "__main__":
    main(**command_line(__doc__))
