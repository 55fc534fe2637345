"""Multi-process training launch (port of ``examples/multihost_example.py``).

One process per rank. Each rank builds the same synthetic dataset, takes
its 'data' slice (``shard_for_process(mesh=...)``) and feeds it to
``BERT4RecTrainer(mesh=...)``; the global batch is the ranks' slices
together. Under a launcher that sets ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK`` and ``WORLD_SIZE``, run one copy per rank::

    torchrun --nproc-per-node 2 -m \
        bert4rec_tpu_torch.examples.multihost_example

Without one, the script starts its ranks itself (``tools/mesh_run.py``)::

    python -m bert4rec_tpu_torch.examples.multihost_example --ranks 2 \\
        [--model-parallelism 2] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from bert4rec_tpu_torch.core import MeshConfig, create_mesh
from bert4rec_tpu_torch.core import distributed_initialize
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.trainers import BERT4RecTrainer

# the function each rank runs when this script starts its own ranks
CHECK = "bert4rec_tpu_torch.examples.multihost_example:train"


def train(mesh, out=None, vocab_size: int = 1000, hidden: int = 64,
          sequences: int = 512, epochs: int = 2,
          batch_size: int = 64) -> dict:
    """Train on this rank's slice; ``sequences`` rows per 'data' slice,
    ``batch_size`` rows per slice and step."""
    world = mesh.size("data") * mesh.size("model")
    print(f"rank {mesh.rank}/{world} at {mesh.coords} on {mesh.device} "
          f"({mesh.backend}), mesh {mesh.shape}")
    model = BERT4RecModel(config=BERT4RecConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=2,
        num_attention_heads=2, inner_dim=4 * hidden, max_sequence_length=32,
        max_predictions_per_seq=8, vocab_pad_to=world))
    trainer = BERT4RecTrainer(model, mesh=mesh)
    trainer.initialize_model(seed=0)

    # every rank builds the SAME dataset, then takes its 'data' slice
    rng = np.random.default_rng(0)
    seqs = [rng.integers(3, vocab_size, size=int(rng.integers(8, 32)))
            .astype(np.int32) for _ in range(sequences * mesh.size("data"))]
    cfg = MaskingConfig(max_seq_len=32, max_predictions_per_seq=8,
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=0.2)
    ds = ProcessedDataset(seqs, cfg, lambda: vocab_size) \
        .shard_for_process(mesh=mesh)

    history = trainer.train(ds, epochs=epochs, batch_size=batch_size,
                            verbose=mesh.rank == 0)
    loss = history.history["loss"]
    print("final loss:", loss[-1])
    return {"loss": np.asarray(loss), "rows": ds.cardinality()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--model-parallelism", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--vocab-size", type=int, default=1000)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--sequences", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    args = ap.parse_args(argv)
    kw = dict(vocab_size=args.vocab_size, hidden=args.hidden,
              sequences=args.sequences, epochs=args.epochs,
              batch_size=args.batch_size)
    if "MASTER_ADDR" in os.environ:           # one copy per rank
        distributed_initialize(device=args.device)
        mesh = create_mesh(MeshConfig(
            model_parallelism=args.model_parallelism))
        result = train(mesh, **kw)
        torch.distributed.destroy_process_group()
        return result
    from bert4rec_tpu_torch.tools import mesh_run
    out = args.out or tempfile.mkdtemp(prefix="multihost_")
    mp = args.model_parallelism
    mesh_run.launch([CHECK], data=args.ranks // mp, model=mp,
                    device=args.device, out=out, kwargs=kw)
    for r in range(args.ranks):
        with open(os.path.join(out, f"rank{r}.log")) as f:
            print(f.read(), end="")
    return mesh_run.load(out, "train", args.ranks)[0]


if __name__ == "__main__":
    main()
