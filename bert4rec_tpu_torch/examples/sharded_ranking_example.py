"""Full-vocab ranking on a vocab-sharded table (port of
``examples/sharded_ranking_example.py``).

Reddit's vocabulary (335,420 items + [PAD]/[MASK]/[UNK], padded to a
multiple of 1,024) is row-sharded over the mesh's 'model' axis, and
``BERT4RecModel.rank_top_k(mesh=...)`` ranks the whole vocabulary per
masked position: each rank's top-k on its block, then only ``mp * k``
pairs cross the ranks; the ``[B, P, V]`` logits are never gathered. The
dense ranking on the whole table is printed beside it. One copy per rank
under a launcher (``torchrun``), or::

    python -m bert4rec_tpu_torch.examples.sharded_ranking_example \\
        --ranks 2 [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from bert4rec_tpu_torch.core import MeshConfig, create_mesh
from bert4rec_tpu_torch.core import distributed_initialize, partitioning
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel

REDDIT_VOCAB = 335_423   # Reddit: 335,420 items + [PAD]/[MASK]/[UNK]

# the function each rank runs when this script starts its own ranks
CHECK = "bert4rec_tpu_torch.examples.sharded_ranking_example:rank"


def rank(mesh, out=None, vocab_size: int = REDDIT_VOCAB, hidden: int = 128,
         seq: int = 200, k: int = 10) -> dict:
    model = BERT4RecModel(config=BERT4RecConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=2,
        num_attention_heads=4, inner_dim=4 * hidden, max_sequence_length=seq,
        max_predictions_per_seq=40,
        vocab_pad_to=1024))   # pad V so it divides the 'model' axis
    whole = model.init(torch.Generator().manual_seed(0), device=mesh.device)
    params = partitioning.shard_state(mesh, whole)

    rng = np.random.default_rng(0)
    dev = mesh.device
    batch = {
        "input_word_ids": torch.from_numpy(rng.integers(
            3, vocab_size, size=(4, seq)).astype(np.int32)).to(dev),
        "input_mask": torch.ones((4, seq), dtype=torch.int32, device=dev),
        "masked_lm_positions": torch.tensor(
            [[0, 1], [2, 3], [4, 5], [6, 7]], dtype=torch.int32,
            device=dev),
    }
    # per-shard top-k + merge; exclude e.g. the special tokens per row
    exclude = torch.from_numpy(np.tile([0, 1, 2, -1], (4, 1))
                               .astype(np.int32)).to(dev)
    with torch.no_grad():
        top_ids, top_probs = model.rank_top_k(
            params, batch, k, mesh=mesh, exclude=exclude,
            with_probabilities=True)
        dense_ids, dense_probs = model.rank_top_k(
            whole, batch, k, exclude=exclude, with_probabilities=True)
    print(f"rank {mesh.rank}: table block "
          f"{tuple(params['encoder']['item_embeddings']['embedding'].shape)}"
          f" of {model.config.padded_vocab_size} rows")
    print("top-10 ids per position:", top_ids[0, 0].tolist())
    print("their probabilities:", top_probs[0, 0].tolist())
    print("dense ranking's ids:   ", dense_ids[0, 0].tolist())
    return {"top_ids": top_ids, "top_probs": top_probs,
            "dense_ids": dense_ids, "dense_probs": dense_probs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--vocab-size", type=int, default=REDDIT_VOCAB)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--seq", type=int, default=200)
    args = ap.parse_args(argv)
    kw = dict(vocab_size=args.vocab_size, hidden=args.hidden, seq=args.seq)
    if "MASTER_ADDR" in os.environ:           # one copy per rank
        distributed_initialize(device=args.device)
        world = torch.distributed.get_world_size()
        result = rank(create_mesh(MeshConfig(model_parallelism=world)), **kw)
        torch.distributed.destroy_process_group()
        return result
    from bert4rec_tpu_torch.tools import mesh_run
    out = args.out or tempfile.mkdtemp(prefix="sharded_ranking_")
    mesh_run.launch([CHECK], data=1, model=args.ranks,
                    device=args.device, out=out, kwargs=kw)
    for r in range(args.ranks):
        with open(os.path.join(out, f"rank{r}.log")) as f:
            print(f.read(), end="")
    return mesh_run.load(out, "rank", args.ranks)[0]


if __name__ == "__main__":
    main()
