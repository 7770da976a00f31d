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
  swept through variant builds (``tools/sweep_tiles.py``);
- :mod:`jpeg_tpu_torch.tools.sentinel`: K3, K4 and K7 run twice over the
  fuzz's damaged cases with their ``torch.empty`` outputs pre-filled by
  two different bytes, every entry a consumer reads equal.

The host C++ runtime's tools (no card needed):

- :mod:`jpeg_tpu_torch.tools.ab_host_entropy`: interleaved same-process
  A/B of runtime builds, the shipping one among them
  (``tools/ab_host_entropy.py``);
- :mod:`jpeg_tpu_torch.tools.abench`: the quick host-entropy rates
  ``seq``, ``corpus``, ``spec``, ``arith``, ``prog`` (``tools/abench.py``);
- :mod:`jpeg_tpu_torch.tools.dump_scan`, :mod:`~.dump_prog`: a scan's
  arrays as ``.bin`` files (``tools/dump_scan.py``, ``dump_prog.py``);
- :mod:`jpeg_tpu_torch.tools.microbench`: builds and runs the C++
  microbenchmarks ``csrc/profile_entropy.cpp``, ``profile_prog.cpp``,
  ``profile_arith.cpp``, ``ab_qm_interleave.cpp``;
- :mod:`jpeg_tpu_torch.tools.arith_ref`: libjpeg's QM-coder ground truth
  (``csrc/jpeg_arith_ref.c``; needs ``jpeglib.h``);
- :mod:`jpeg_tpu_torch.tools.asan_sweep`: the fuzz's cases through the
  runtime and encoder built with AddressSanitizer (``JPEG_TPU_ASAN=1``).

On the card (run through ``python -m``)::

    python -m jpeg_tpu_torch.tools.fuzz 0 40
    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python -m jpeg_tpu_torch.tools.fuzz 0 40 --clean-size 256x128 --no-twins
    python -m jpeg_tpu_torch.tools.bench_device_spec
    python -m jpeg_tpu_torch.tools.ablate_kernel
    python -m jpeg_tpu_torch.tools.sweep_tiles
    python -m jpeg_tpu_torch.tools.ab_host_entropy o2=-O2
    python -m jpeg_tpu_torch.tools.abench seq corpus spec arith prog
    python -m jpeg_tpu_torch.tools.microbench
    python -m jpeg_tpu_torch.tools.asan_sweep --seeds 0-2

(``compute-sanitizer`` lies beside ``nvcc``; run it with
``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, and ``--tool initcheck`` the same
way.) Each runs on ``cuda`` unless ``--device cpu`` is given, where the
tool allows the CPU: the fuzz and the ladder run their routes' plain twins
there (``python -m jpeg_tpu_torch.tools.fuzz 0 2 --device cpu --clean-size
128x64``, ``python -m jpeg_tpu_torch.tools.bench_device_spec --device cpu
--size 128x64 64:8``); the ablation and the sweep time CUDA builds and
need the card. None falls back to the CPU when no card is found. The host
tools need no card and run alike on any host (``--size 512x384`` for a
quick run).
"""
