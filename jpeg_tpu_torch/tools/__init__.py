"""Run-time tools of the port, each a counterpart of a tool of the repo-root
``tools/``:

- :mod:`jpeg_tpu_torch.tools.endurance`: a sustained corpus run through the
  command line, killed partway and resumed in recycled processes, with the
  host and card memory sampled throughout (``tools/endurance.py``);
- :mod:`jpeg_tpu_torch.tools.measure_approx_quality`: the approx IDCT
  tier's quality gate, K1a against K1 over the corpus matrix
  (``tools/measure_approx_quality.py``);
- :mod:`jpeg_tpu_torch.tools.fuzz`: the corrupt-stream fuzz, the JAX
  tool's 20 variants and seeds through both engines and every kernel route
  (K1, K3, K4, K7, the hybrid corpus decoder) (``tools/fuzz.py``);
- :mod:`jpeg_tpu_torch.tools.bench_device_spec`: K7's lanes x overlap
  ladder on 4K frames with and without restarts
  (``tools/bench_device_spec.py``);
- :mod:`jpeg_tpu_torch.tools.ablate_kernel`: K3's pass 1 timed with one
  cost term taken out at a time, from ``tools/csrc/k3_ablate.cu``
  (``tools/ablate_kernel.py``);
- :mod:`jpeg_tpu_torch.tools.sweep_tiles`: K1's (and K1a's) cell shape
  swept through variant builds (``tools/sweep_tiles.py``).

On the card (run through ``python -m``)::

    python -m jpeg_tpu_torch.tools.fuzz 0 40
    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python -m jpeg_tpu_torch.tools.fuzz 0 40 --clean-size 256x128 --no-twins
    python -m jpeg_tpu_torch.tools.bench_device_spec
    python -m jpeg_tpu_torch.tools.ablate_kernel
    python -m jpeg_tpu_torch.tools.sweep_tiles

(``compute-sanitizer`` lies beside ``nvcc``; run it with
``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, and ``--tool initcheck`` the same
way.) Each runs on ``cuda`` unless ``--device cpu`` is given, where the
tool allows the CPU: the fuzz and the ladder run their routes' plain twins
there (``python -m jpeg_tpu_torch.tools.fuzz 0 2 --device cpu --clean-size
128x64``, ``python -m jpeg_tpu_torch.tools.bench_device_spec --device cpu
--size 128x64 64:8``); the ablation and the sweep time CUDA builds and
need the card. None falls back to the CPU when no card is found.
"""
