"""deciphonctl: operator CLI for a remote scheduler (parity: control/).

Subcommand tree mirrors control/deciphonctl/cli.py: config, hmm add/rm/ls,
db add/rm/ls, job ls/set, scan post/ls/rm, seq ls, snap get/view/gff/...
Configuration comes from DECIPHONCTL_SCHED_URL or ~/.config/deciphonctl.
"""

from __future__ import annotations

import json
import os
import sys

import click

from .poster import Poster

CONFIG_PATH = os.path.expanduser("~/.config/deciphon_tpu_torch/deciphonctl.json")


def load_url(explicit: str | None = None) -> str:
    if explicit:
        return explicit
    url = os.environ.get("DECIPHONCTL_SCHED_URL")
    if url:
        return url
    if os.path.exists(CONFIG_PATH):
        with open(CONFIG_PATH) as fp:
            return json.load(fp)["sched_url"]
    raise click.ClickException(
        "no scheduler configured: pass --sched, set DECIPHONCTL_SCHED_URL, "
        "or run `deciphonctl config set-url URL`")


def make_poster(ctx) -> Poster:
    return Poster(load_url(ctx.obj.get("sched_url")))


@click.group()
@click.option("--sched", "sched_url", default=None,
              help="Scheduler base URL (overrides config/env).")
@click.pass_context
def cli(ctx, sched_url):
    """Operator CLI for a deciphon-tpu scheduler."""
    ctx.ensure_object(dict)
    ctx.obj["sched_url"] = sched_url


# -- config ---------------------------------------------------------------
@cli.group()
def config():
    """Manage the local deciphonctl configuration."""


@config.command("set-url")
@click.argument("url")
def config_set_url(url):
    os.makedirs(os.path.dirname(CONFIG_PATH), exist_ok=True)
    with open(CONFIG_PATH, "w") as fp:
        json.dump({"sched_url": url}, fp)
    click.echo(f"saved {CONFIG_PATH}")


@config.command("show")
@click.pass_context
def config_show(ctx):
    click.echo(load_url(ctx.obj.get("sched_url")))


# -- hmm ------------------------------------------------------------------
@cli.group()
def hmm():
    """Manage profile HMM files."""


@hmm.command("add")
@click.argument("path", type=click.Path(exists=True, dir_okay=False))
@click.option("--gencode", type=int, default=1, show_default=True)
@click.option("--epsilon", type=float, default=0.01, show_default=True)
@click.pass_context
def hmm_add(ctx, path, gencode, epsilon):
    poster = make_poster(ctx)
    poster.upload("hmms", path)
    out = poster.hmm_post(os.path.basename(path), gencode, epsilon)
    click.echo(json.dumps(out))


@hmm.command("ls")
@click.pass_context
def hmm_ls(ctx):
    click.echo(json.dumps(make_poster(ctx).hmm_list(), indent=2))


@hmm.command("rm")
@click.argument("hmm_id", type=int)
@click.pass_context
def hmm_rm(ctx, hmm_id):
    make_poster(ctx).hmm_delete(hmm_id)


# -- db -------------------------------------------------------------------
@cli.group()
def db():
    """Manage pressed databases."""


@db.command("add")
@click.argument("path", type=click.Path(exists=True, dir_okay=False))
@click.pass_context
def db_add(ctx, path):
    poster = make_poster(ctx)
    poster.upload("dbs", path)
    click.echo(json.dumps(poster.db_post(os.path.basename(path))))


@db.command("ls")
@click.pass_context
def db_ls(ctx):
    click.echo(json.dumps(make_poster(ctx).db_list(), indent=2))


@db.command("rm")
@click.argument("db_id", type=int)
@click.pass_context
def db_rm(ctx, db_id):
    make_poster(ctx).db_delete(db_id)


# -- job ------------------------------------------------------------------
@cli.group()
def job():
    """Inspect and update jobs."""


@job.command("ls")
@click.pass_context
def job_ls(ctx):
    click.echo(json.dumps(make_poster(ctx).job_list(), indent=2))


@job.command("get")
@click.argument("job_id", type=int)
@click.pass_context
def job_get(ctx, job_id):
    click.echo(json.dumps(make_poster(ctx).job_get(job_id), indent=2))


# -- scan -----------------------------------------------------------------
@cli.group()
def scan():
    """Submit and inspect scans."""


@scan.command("post")
@click.argument("db_id", type=int)
@click.argument("seqfile", type=click.Path(exists=True, dir_okay=False))
@click.option("--multi-hits/--no-multi-hits", default=True)
@click.option("--hmmer3-compat/--no-hmmer3-compat", default=False)
@click.pass_context
def scan_post(ctx, db_id, seqfile, multi_hits, hmmer3_compat):
    from .scan.fasta_io import read_fasta

    seqs = [{"name": name.split()[0] if name else str(i + 1), "data": data}
            for i, (name, data) in enumerate(read_fasta(seqfile))]
    out = make_poster(ctx).scan_post(db_id, seqs, multi_hits, hmmer3_compat)
    click.echo(json.dumps(out))


@scan.command("ls")
@click.pass_context
def scan_ls(ctx):
    click.echo(json.dumps(make_poster(ctx).scan_list(), indent=2))


@scan.command("rm")
@click.argument("scan_id", type=int)
@click.pass_context
def scan_rm(ctx, scan_id):
    make_poster(ctx).scan_delete(scan_id)


# -- seq ------------------------------------------------------------------
@cli.group()
def seq():
    """Inspect submitted sequences."""


@seq.command("ls")
@click.pass_context
def seq_ls(ctx):
    click.echo(json.dumps(make_poster(ctx).seq_list(), indent=2))


# -- snap -----------------------------------------------------------------
@cli.group()
def snap():
    """Fetch and render scan results."""


@snap.command("get")
@click.argument("scan_id", type=int)
@click.argument("dest", type=click.Path())
@click.pass_context
def snap_get(ctx, scan_id, dest):
    data = make_poster(ctx).snap_get(scan_id)
    with open(dest, "wb") as fp:
        fp.write(data)
    click.echo(f"wrote {dest}")


@snap.command("add")
@click.argument("scan_id", type=int)
@click.argument("dcs", type=click.Path(exists=True, dir_okay=False))
@click.pass_context
def snap_add(ctx, scan_id, dcs):
    click.echo(json.dumps(make_poster(ctx).snap_post(scan_id, dcs)))


@snap.command("rm")
@click.argument("scan_id", type=int)
@click.pass_context
def snap_rm(ctx, scan_id):
    make_poster(ctx).snap_delete(scan_id)


def _view_command(kind):
    @snap.command(kind)
    @click.argument("scan_id", type=int)
    @click.pass_context
    def _cmd(ctx, scan_id):
        out = make_poster(ctx).snap_view(scan_id, kind)
        click.echo(out if isinstance(out, str) else json.dumps(out, indent=2))

    _cmd.__name__ = f"snap_{kind}"
    return _cmd


for _kind in ("view", "gff", "prods", "queries", "states", "codons",
              "aminos"):
    _view_command(_kind)


def main():
    cli(prog_name="deciphonctl")


if __name__ == "__main__":
    sys.exit(main())
