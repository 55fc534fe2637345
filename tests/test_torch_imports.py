"""The port stands alone: importing every module of ``bert4rec_tpu_torch``
(and ``chip_smoke.py``) imports neither JAX, the JAX package, the root
``bench.py``, ``tools/`` nor the JAX package's ``examples/``, and its
entry points refuse to fall back to
the CPU when CUDA is absent."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bert4rec_tpu_torch.apps import Recommender
from bert4rec_tpu_torch.core import resolve_device
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.models import BERT4RecModelWrapper, Bert4RecEncoder
from bert4rec_tpu_torch.ops import kernel_build
from bert4rec_tpu_torch.utils.checkpoint import params_from_numpy


def test_no_module_imports_jax_or_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import bert4rec_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            bert4rec_tpu_torch.__path__, "bert4rec_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        # nor the JAX package's scripts: the root bench.py, tools/ and
        # examples/
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bert4rec_tpu" or m.startswith("bert4rec_tpu.")
                     or m in ("bench", "tools", "examples")
                     or m.startswith(("tools.", "examples.")))
        print(len(names), bad)
        assert len(names) >= 30 and not bad, bad
        # the host pipeline's, SASRec's, evaluation's, the quality
        # harness's, the deployment surface's and the multi-GPU layout's
        # modules are among them,
        # and importing them builds nothing (the masking engine compiles
        # at first use)
        for mod in ("datasets.ml_20m", "datasets.reddit",
                    "dataloaders.concrete_dataloaders",
                    "dataloaders.processed_dataset", "dataloaders.native",
                    "utils.prefetch", "models.sasrec_model",
                    "dataloaders.preprocessors.sasrec_preprocessor",
                    "dataloaders.samplers.popular_random_sampler",
                    "evaluation.bert4rec_evaluator",
                    "evaluation.evaluation_metrics",
                    "ops.candidate_scoring", "ops.negative_sampling",
                    "evaluation.baselines", "evaluation.markov_oracle",
                    "evaluation.temporal_oracle",
                    "evaluation.quality_harness", "tools.quality_run",
                    "models.export", "models.quantization", "apps.ranker",
                    "utils.profiling", "examples.save_and_load",
                    "examples.ranker_app", "examples.serving_export",
                    "core.mesh", "core.partitioning",
                    "ops.sharded_mlm_loss", "tools.mesh_run",
                    "examples.multihost_example",
                    "examples.sharded_ranking_example", "tools.bench",
                    "tools.config_sweep", "tools.perf_guard",
                    "tools.serving_bench", "tools.release_check",
                    "examples._common", "examples.bert4rec_ml_1m_example",
                    "examples.bert4rec_beauty_example",
                    "examples.bert4rec_steam_example",
                    "examples.bert4rec_ml_20m_example",
                    "examples.bert4rec_reddit_example",
                    "examples.bert4rec_evaluation_example",
                    "examples.recommender_app_example",
                    "examples.serving_server_example",
                    "examples.bert4rec_lifecycle_example",
                    "examples.loss_calculation_example",
                    "examples.temporal_features_example",
                    "examples.sasrec_example",
                    "examples.dataloader_usage_example"):
            assert "bert4rec_tpu_torch." + mod in names, mod
        from bert4rec_tpu_torch.dataloaders import native
        assert native._lib is None
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def small_model():
    return BERT4RecModel(config=BERT4RecConfig(
        vocab_size=10, hidden_size=8, num_layers=1, num_attention_heads=2,
        inner_dim=16, max_sequence_length=6))


def test_default_device_raises_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    model = small_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Recommender(model, params, BERT4RecDataloader(6, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"a/b": np.zeros(3, np.float32)})
    path = BERT4RecModelWrapper(model, params).save(tmp_path / "m", mode=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        BERT4RecModelWrapper.load(path, mode=2)
    # asking for the CPU is always allowed
    wrapper, _ = BERT4RecModelWrapper.load(path, mode=2, device="cpu")
    assert wrapper.params["mlm"]["output_bias"].device.type == "cpu"


def test_encoder_init_defaults_to_the_card(no_cuda):
    encoder = Bert4RecEncoder(small_model().config)
    with pytest.raises(RuntimeError, match="CUDA"):
        encoder.init(torch.Generator().manual_seed(0))
    params = encoder.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["pooler"]["kernel"].device.type == "cpu"
    assert encoder.init(device="meta")["pooler"]["kernel"].is_meta


def test_trainer_defaults_to_the_card(no_cuda):
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer
    trainer = BERT4RecTrainer(small_model())
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.initialize_model()
    trainer.initialize_model(device="cpu")
    assert trainer.params["mlm"]["output_bias"].device.type == "cpu"


def test_kernel_sources_are_found_and_nothing_is_built_at_import():
    assert kernel_build.kernel_sources() == ["adamw", "expert_gemm",
                                             "flash_attention",
                                             "fused_encoder_layer",
                                             "fused_mlm_loss", "layer_tf32",
                                             "table_grad"]
    assert kernel_build._libs == {}


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "import chip_smoke; sys.exit(chip_smoke.main())"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_mesh_defaults_to_the_card(no_cuda):
    from bert4rec_tpu_torch.core import create_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        create_mesh()
    assert create_mesh(device="cpu").device.type == "cpu"
