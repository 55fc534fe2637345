"""bert4rec_tpu_torch — the PyTorch/CUDA port of ``bert4rec_tpu``.

The JAX package beside this one is the reference each module here is held
against. Plain tensor code is PyTorch; every Pallas kernel of the JAX
package that this port covers is a hand-written Hopper (``sm_90a``) CUDA
kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/kernel_build.py``).

Ported so far: the serving path — ``BERT4RecModelWrapper.load`` ->
``apps.Recommender`` -> ``apps.RecommenderService`` -> ``apps.ServingServer``
— with the fused post-LN encoder-layer forward as a CUDA kernel
(``ops/fused_encoder_layer.py``). Entry points take ``device=`` and default
to ``"cuda"``; without CUDA they raise unless the CPU is asked for.

Importing this package imports neither ``jax`` nor ``bert4rec_tpu``.
"""

__version__ = "0.1.0"
