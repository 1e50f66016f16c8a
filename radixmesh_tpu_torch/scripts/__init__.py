"""The port's artifact command lines, one module per ``scripts/*.py`` of the
JAX package, with the same flags, output line, exit codes and
``--write-artifact``; each builds and validates its report through
``radixmesh_tpu_torch.reports`` and writes ``<KIND>_torch_r{N}.json``.

The command lines that build engines (``specbench``, ``convoybench``,
``kvflowbench``, ``tierbench``, ``obsbench``, ``blackboxbench``,
``aggbench``, ``soak``) run on the card unless ``--device cpu`` is given,
at Llama-3-8B's widths 2 layers deep, or with ``--model toy`` on the JAX
scenario's own model. ``fleetbench``,
``chaosbench``, ``rebalancebench``, ``ringbench``, ``ringscale`` and
``benchdiff`` run on the host alone.

    python -m radixmesh_tpu_torch.scripts.specbench [--device cpu --model toy] [--out FILE]
"""
