"""deciphon-tpu on PyTorch and CUDA: the scan engine for NVIDIA Hopper.

The port keeps the `deciphon_tpu` layout, so a reader finds a module's
counterpart under the same relative path, but it is a package of its own:
it imports torch, never jax, and nothing of `deciphon_tpu`.  What it needs
of that package's host code (profiles, frame tables, windows, sequences,
decoder, product writer, metrics, the scheduler's host helpers) it keeps
as its own copies; `convert.py` builds the port's objects from plain numpy
arrays, which is how tests carry a reference profile or sequence across.

Entry point (one device, default flags, no confirmer):

    from deciphon_tpu_torch.scan.pipeline import ScanConfig, Scanner
    Scanner(profiles, ScanConfig(device="cuda")).run(sequences, outdir)

which writes `outdir/products.tsv`.  On a CUDA device the hot loops run
hand-written kernels from `csrc/` (built on first use by `_build.py`); on
the CPU every kernel wrapper runs its plain PyTorch version.  From files:
`python -m deciphon_tpu_torch.cli press|warmup|scan|see` (cli.py), or
`core.Scan` (the python-core API).
"""

__version__ = "0.1.0"
