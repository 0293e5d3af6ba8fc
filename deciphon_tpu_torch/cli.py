"""Command-line interface: press / warmup / scan / see / worker (parity:
cli/deciphon/cli.py), on the port's engines.

    python -m deciphon_tpu_torch.cli press FILE.hmm GENCODE   -> FILE.dcp
    python -m deciphon_tpu_torch.cli warmup FILE.dcp
    python -m deciphon_tpu_torch.cli scan FILE.dcp SEQS.fna   -> SEQS.dcs
    python -m deciphon_tpu_torch.cli see SNAP.dcs             (alignments)
    python -m deciphon_tpu_torch.cli worker --sched URL       (press and
                                    scan jobs of a scheduler, worker_daemon)

`scan`, `warmup` and `worker` run on the card (`--device cuda`, the
default) or, when asked, on the CPU (`--device cpu`, the kernels' plain
versions); without a card, `--device cuda` stops with an error and never
falls back to the CPU.  `--engine` picks the scorer: `kernels` (the
hand-written kernels), `kernels-multi` (the same over every visible card),
`torch` (plain PyTorch) or `native` (the C++ CPU engine, its phase 2 on
the device).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import click

from .gencode import GENCODE_IDS

ENGINE = click.Choice(["kernels", "kernels-multi", "torch", "native"])
DEVICE = click.Choice(["cuda", "cpu"])


def _require_device(device: str) -> None:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise click.ClickException(
            "--device cuda: no CUDA device is available (pass --device cpu "
            "to run on the CPU)")


@click.group()
def cli():
    """Deciphon on PyTorch and CUDA: protein annotation on nucleotide
    long reads."""


@cli.command()
@click.argument("hmmfile", type=click.Path(exists=True, dir_okay=False))
@click.argument("gencode", type=int)
@click.option("--epsilon", type=float, default=0.01, show_default=True,
              help="Nucleotide error probability.")
@click.option("--output", type=click.Path(), default=None,
              help="Output .dcp path (default: input with .dcp suffix).")
@click.option("--progress/--no-progress", default=True)
def press(hmmfile, gencode, epsilon, output, progress):
    """Press a HMMER3 .hmm file into a .dcp frame-profile database."""
    if gencode not in GENCODE_IDS:
        raise click.BadParameter(f"unknown genetic code {gencode}")
    from .press import press as do_press

    bar = None
    if progress:
        import rich.progress as rp

        bar = rp.Progress(*rp.Progress.get_default_columns(),
                          rp.MofNCompleteColumn())
        bar.start()
        task = bar.add_task("press", total=None)

        def cb(done, total):
            bar.update(task, completed=done, total=total)
    else:
        cb = None
    try:
        out = do_press(str(hmmfile), output, gencode, epsilon, progress=cb)
    finally:
        if bar is not None:
            bar.stop()
    click.echo(f"wrote {out}")
    # hmmpgmd needs hmmpress side files (h3m/h3i/h3f/h3p); the reference
    # CLI always runs `hmmpress -f` after pressing (cli/deciphon/
    # hmmer_press.py:9-10).  Only possible when HMMER is installed.
    import subprocess

    if shutil.which("hmmpress"):
        subprocess.run(["hmmpress", "-f", str(hmmfile)], check=False,
                       capture_output=True)


@cli.command()
@click.argument("dbfile", type=click.Path(exists=True, dir_okay=False))
@click.option("--read-length", "read_lengths", type=int, multiple=True,
              help="Expected read length(s); default = one full window "
                   "per distinct profile core size plus a 10 knt read. "
                   "Chain-tier shapes pin to the warmup reads' length "
                   "mix, so pass your production read length.")
@click.option("--reads-per-length", type=int, default=1, show_default=True,
              help="Synthetic reads per length (more reads exercise the "
                   "wider chunk shapes a deep scan uses).")
@click.option("--engine", type=ENGINE, default="kernels", show_default=True)
@click.option("--device", type=DEVICE, default="cuda", show_default=True)
def warmup(dbfile, read_lengths, reads_per_length, engine, device):
    """Scan synthetic reads once against DBFILE, so that the kernels are
    built (the build is cached under build/) and a scan in this process
    starts warm."""
    _require_device(device)
    from .io.dcp import read_dcp_profiles
    from .scan.pipeline import ScanConfig, Scanner

    _, profiles = read_dcp_profiles(str(dbfile))
    scanner = Scanner(profiles, ScanConfig(engine=engine, device=device))
    dt = scanner.warmup(list(read_lengths) or None,
                        reads_per_length=reads_per_length)
    click.echo(f"warmup done in {dt:.1f}s "
               f"({len(profiles)} profiles, engine={engine}, "
               f"device={device})")


@cli.command()
@click.argument("dbfile", type=click.Path(exists=True, dir_okay=False))
@click.argument("seqfile", type=click.Path(exists=True, dir_okay=False))
@click.option("--snap", type=click.Path(), default=None,
              help="Output .dcs path (default: SEQFILE base + .dcs).")
@click.option("--multi-hits/--no-multi-hits", default=True, show_default=True)
@click.option("--hmmer3-compat/--no-hmmer3-compat", default=False,
              show_default=True)
@click.option("--engine", type=ENGINE, default="kernels", show_default=True)
@click.option("--device", type=DEVICE, default="cuda", show_default=True)
@click.option("--hmmer", "hmmer_port", type=int, default=None,
              help="Confirm hits against hmmpgmd on this port.")
@click.option("--confirm", "confirm_mode",
              type=click.Choice(["none", "native"]), default="none",
              show_default=True,
              help="E-value confirmation: 'native' runs the built-in amino "
                   "Forward scorer on the device (needs the paired .hmm "
                   "next to the .dcp).")
@click.option("--progress/--no-progress", default=True)
@click.option("--profile-dir", type=click.Path(file_okay=False), default=None,
              help="Write a torch.profiler Chrome trace of the scan into "
                   "this directory (view with Perfetto or chrome://tracing): "
                   "the scan's deciphon.* spans (run, setup, per wave "
                   "phase1_dispatch ... phase2_decode, write, wait, copy) "
                   "beside the kernels and copies they issued.")
def scan(dbfile, seqfile, snap, multi_hits, hmmer3_compat, engine, device,
         hmmer_port, confirm_mode, progress, profile_dir):
    """Scan sequences against a pressed database; write a .dcs snap."""
    _require_device(device)
    from .io.dcp import read_dcp_profiles
    from .scan.fasta_io import read_sequences
    from .scan.pipeline import ScanConfig, Scanner
    from .snap.snap_file import make_snap_archive

    if snap is None:
        snap = os.path.splitext(str(seqfile))[0] + ".dcs"
    if os.path.exists(snap):
        raise click.ClickException(f"{snap} already exists")

    _, profiles = read_dcp_profiles(str(dbfile))
    sequences = read_sequences(seqfile)

    confirmer = None
    if hmmer_port is not None:
        from .hmmer.client import HMMERClient

        client = HMMERClient("127.0.0.1", hmmer_port,
                             num_proteins=len(profiles),
                             has_ga=all(p.has_ga for p in profiles))
        confirmer = client.confirm
    elif confirm_mode == "native":
        from .hmmer.forward import NativeConfirmer
        from .hmmfile import read_hmm

        hmm_path = os.path.splitext(str(dbfile))[0] + ".hmm"
        if not os.path.exists(hmm_path):
            raise click.ClickException(
                f"native confirmation needs {hmm_path} next to the .dcp")
        confirmer = NativeConfirmer(read_hmm(hmm_path), device=device).confirm

    cfg = ScanConfig(multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
                     engine=engine, device=device)
    scanner = Scanner(profiles, cfg, confirmer=confirmer)

    workdir = tempfile.mkdtemp(prefix="deciphon_scan_")
    basedir = os.path.join(
        workdir, os.path.splitext(os.path.basename(str(snap)))[0])
    os.makedirs(basedir)
    try:
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                scanner.run(sequences, basedir)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "scan_trace.json"))
        else:
            scanner.run(sequences, basedir)
        make_snap_archive(basedir, str(snap))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    click.echo(f"wrote {snap}")
    if profile_dir:
        click.echo(f"profiler trace in {profile_dir}")


@cli.command()
@click.argument("snapfile", type=click.Path(exists=True, dir_okay=False))
def see(snapfile):
    """Pretty-print the alignments stored in a .dcs snap."""
    from .snap.snap_file import read_snap
    from .snap.view import view_alignments

    snap = read_snap(snapfile)
    click.echo(str(snap))
    click.echo()
    click.echo(view_alignments(snap.products))


@cli.command()
@click.option("--sched", "sched_url", required=True,
              help="Scheduler base URL, e.g. http://127.0.0.1:49329")
@click.option("--engine", type=ENGINE, default="kernels", show_default=True)
@click.option("--device", type=DEVICE, default="cuda", show_default=True,
              help="Where scans run; without a card, cuda stops with an "
                   "error before any job is claimed.")
@click.option("--confirm", type=click.Choice(["none", "native"]),
              default="none", show_default=True)
@click.option("--workdir", default=None)
def worker(sched_url, engine, device, confirm, workdir):
    """Consume press/scan jobs from a scheduler until interrupted."""
    _require_device(device)
    from .poster import Poster
    from .worker_daemon import WorkerLoop

    poster = Poster(sched_url)
    poster.handshake()
    loop = WorkerLoop(poster, workdir=workdir, engine=engine,
                      confirm=confirm, device=device)
    click.echo(f"worker consuming from {sched_url}")
    loop.run_forever()


def main(args=None, standalone_mode: bool = True):
    """Run the CLI on `args` (sys.argv by default); with
    standalone_mode=False, return instead of exiting and let exceptions
    through (for callers that run it in process)."""
    return cli.main(args=args, prog_name="deciphon",
                    standalone_mode=standalone_mode)


if __name__ == "__main__":
    sys.exit(main())
