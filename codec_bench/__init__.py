"""The port's benchmark (``python3 codec_bench/run.py --help``); see README.md."""
