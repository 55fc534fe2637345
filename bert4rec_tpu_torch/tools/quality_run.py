"""The quality harness's command line (the flags of the JAX package's
``tools/quality_run.py``, and ``--device``):

    python -m bert4rec_tpu_torch.tools.quality_run --smoke --device cpu
    python -m bert4rec_tpu_torch.tools.quality_run --oracle --oracle-scale ml1m
    python -m bert4rec_tpu_torch.tools.quality_run --oracle \\
        --oracle-family temporal --oracle-scale ml20m --full-ranking

Without ``--smoke`` or ``--oracle`` it trains the reference's headline
configuration on a corpus already on disk (``--dataset``), or exits with
2 when there is none. Modes run on the card unless ``--device cpu``; each
writes ``eval_results.json`` under ``quality_runs/torch/<mode>`` (or
``--out``) and exits non-zero when a gate fails. The modes themselves are
in ``bert4rec_tpu_torch.evaluation.quality_harness``.
"""

import sys

from bert4rec_tpu_torch.evaluation.quality_harness import main

if __name__ == "__main__":
    sys.exit(main())
