"""bert4rec_tpu_torch — the PyTorch/CUDA port of ``bert4rec_tpu``.

The JAX package beside this one is the reference each module here is held
against. Plain tensor code is PyTorch; every Pallas kernel of the JAX
package that this port covers is a hand-written Hopper (``sm_90a``) CUDA
kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/kernel_build.py``).

Ported so far: the serving path — ``BERT4RecModelWrapper.load`` ->
``apps.Recommender`` -> ``apps.RecommenderService`` -> ``apps.ServingServer``;
training — ``trainers.BERT4RecTrainer`` with its ``train()`` loop; and the
host pipeline that feeds it — ``datasets`` and ``dataloaders``
(``get_dataloader_factory()`` -> ``prepare_training``); the SASRec family
(``models.SASRecModel``, the ``"sasrec"`` preprocessor); and evaluation —
``evaluation.BERT4RecEvaluator`` (101 sampled candidates, host or device
negatives, or the full catalog). The fused encoder layer, bidirectional
and causal (``ops/fused_encoder_layer.py``), and the fused tied-softmax
loss, whole-table and vocab-tiled (``ops/fused_mlm_loss.py``), are CUDA
kernels.
Entry points take ``device=`` and default to ``"cuda"``; without CUDA they
raise unless the CPU is asked for.

Importing this package imports neither ``jax`` nor ``bert4rec_tpu``.
"""

__version__ = "0.1.0"
