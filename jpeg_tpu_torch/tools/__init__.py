"""Run-time evidence tools of the port, each a counterpart of a tool of the
repo-root ``tools/``:

- :mod:`jpeg_tpu_torch.tools.endurance`: a sustained corpus run through the
  command line, killed partway and resumed in recycled processes, with the
  host and card memory sampled throughout (``tools/endurance.py``);
- :mod:`jpeg_tpu_torch.tools.measure_approx_quality`: the approx IDCT
  tier's quality gate, K1a against K1 over the corpus matrix
  (``tools/measure_approx_quality.py``).

Both run on ``cuda`` unless ``--device cpu`` is given.
"""
