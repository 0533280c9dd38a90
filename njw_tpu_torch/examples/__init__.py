"""Runnable examples: counterparts of the scripts in ``examples/``.

One module per script, under the same name, run as

    python -m njw_tpu_torch.examples.<name> [--device cpu] [...]

Each takes the JAX script's arguments with the same defaults, plus
``--device`` (CUDA unless given), prints what the JAX script prints and
writes the same files to ``--output-dir``. ``main(argv=None)`` returns an
exit code, so a caller may run an example in its own process. Plots go
through ``njw_tpu_torch.viz``; where matplotlib is missing an example
says in one line that its plots were not drawn and computes and prints
everything else.
"""
