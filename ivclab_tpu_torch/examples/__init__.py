"""The lab's chapter examples on the port (twins of the repository's
``examples/ch1_basics.py`` .. ``ch4_video.py``).

Each prints the same lines, in the same order and with the same format
strings, as its JAX twin, so the two outputs compare line by line. Each
takes ``--device`` (default ``cuda``) and has ``main(argv=None)``:

    python3 -m ivclab_tpu_torch.examples.ch3_intra [--device cuda|cpu] [--plot DIR]
"""
