"""Scripts of the port: measurement scripts, each run as a file on a CUDA
card, and the quality harness's command line (``quality_run``)."""
