"""Serving export (port of ``examples/serving_export_example.py``): export
the serving computation with the weights inside to one ``.pt2`` file, then
serve it without the model code.

``torch.export`` traces top-k ranking at a symbolic batch; the kernels are
registered operators the program calls, so the serving side needs the
artifact and ``bert4rec_tpu_torch.ops``, not the model's code or weight
files. An int8 artifact holds the item table weights-only quantized. An
``ArtifactRecommender`` over an artifact exported with an exclusion input
serves ``recommend_batch`` and drops into ``RecommenderService``. Random
weights at the ml-1m_128 shape::

    python -m bert4rec_tpu_torch.examples.serving_export [--out DIR] \\
        [--device cpu]
"""

import argparse
import pathlib
import tempfile

import numpy as np
import torch

from bert4rec_tpu_torch.apps import ArtifactRecommender, RecommenderService
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel, export

SEQ, PRED = 200, 40


def main(out_dir=None, device: str = "cuda") -> dict:
    titles = [f"Synthetic Feature No. {i:05d}" for i in range(3706)]
    dataloader = BERT4RecDataloader(SEQ, PRED)
    dataloader.generate_vocab(titles)
    # stand-in for a trained model: BERT4RecModelWrapper.load(...) in a
    # real flow (see save_and_load.py)
    cfg = BERT4RecConfig(vocab_size=dataloader.tokenizer.get_vocab_size(),
                         hidden_size=128, num_layers=2,
                         num_attention_heads=8, inner_dim=512,
                         max_sequence_length=SEQ,
                         max_predictions_per_seq=PRED, use_fused_layer=True)
    model = BERT4RecModel(config=cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    tmp = None
    if out_dir is None:
        tmp = tempfile.TemporaryDirectory()
        out_dir = tmp.name
    out = pathlib.Path(out_dir)
    result = {}
    try:
        # one artifact, any batch up to export.batch_limit, top-10
        path = out / "bert4rec_topk.pt2"
        export.save_artifact(export.export_top_k(model, params, k=10), path)
        result["fp32_bytes"] = path.stat().st_size
        print(f"exported {path} ({result['fp32_bytes'] / 1e6:.1f} MB, "
              f"device {device}, batch up to {export.batch_limit(model)})")

        # --- serving side: the artifact and the port's operators --- #
        served = export.load_artifact(path).module()
        for batch in (1, 4):
            ids = torch.from_numpy(np.random.default_rng(0).integers(
                3, cfg.vocab_size, size=(batch, SEQ)).astype(np.int32))
            mask = torch.ones((batch, SEQ), dtype=torch.int32)
            positions = torch.zeros((batch, PRED), dtype=torch.int32)
            top_ids, _ = served(ids.to(device), mask.to(device),
                                positions.to(device))
            print(f"batch {batch}: top-10 ids {top_ids[0, 0].tolist()}")

        # --- int8 weights-only quantized artifact --- #
        q_path = out / "bert4rec_topk.int8.pt2"
        export.save_artifact(
            export.export_top_k(model, params, k=10, quantize="int8"),
            q_path)
        result["int8_bytes"] = q_path.stat().st_size
        print(f"int8 artifact {q_path} ({result['int8_bytes'] / 1e6:.1f} MB "
              f"vs {result['fp32_bytes'] / 1e6:.1f} MB fp32)")

        # --- recommendation serving from the artifact alone --- #
        r_path = out / "bert4rec_recommend.pt2"
        export.save_artifact(export.export_top_k(model, params, k=10,
                                                 num_exclude=64), r_path)
        rec = ArtifactRecommender(export.load_artifact(r_path), dataloader)
        service = RecommenderService(rec, max_k=10, batch_capacity=8)
        try:
            result["recommended"] = service.recommend(titles[:5], k=3)
        finally:
            service.close()
        print("recommended:", result["recommended"])
    finally:
        if tmp is not None:
            tmp.cleanup()
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.out, args.device)
