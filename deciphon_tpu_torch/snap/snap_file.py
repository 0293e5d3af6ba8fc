""".dcs snap archives: zip{<root>/products.tsv, <root>/hmmer/**.h3r}.

Parity: snap/deciphon_snap/snap_file.py + read_snap.py (zipfile instead of
fsspec) and schema NewSnapFile.make_archive (schema/__init__.py:221-226).
"""

from __future__ import annotations

import os
import zipfile

from ..intervals import PyInterval
from .match import MatchList
from .prod import Prod, ProdList

__all__ = ["SnapFile", "read_snap", "make_snap_archive"]


class SnapFile:
    def __init__(self, zf: zipfile.ZipFile):
        names = zf.namelist()
        roots = {n.split("/", 1)[0] for n in names if n.strip("/")}
        if len(roots) != 1:
            raise ValueError(f"snap must contain one root dir, got {roots}")
        root = roots.pop()
        prod_path = f"{root}/products.tsv"

        prods: list[Prod] = []
        with zf.open(prod_path) as fp:
            rows = [line.decode().rstrip("\r\n") for line in fp]
        fields = rows[0].split("\t")
        for idx, raw in enumerate(rows[1:]):
            row = dict(zip(fields, raw.split("\t")))
            seq_id = int(row["sequence"])
            window = int(row["window"])
            hit = int(row["hit"])
            profile = row["profile"]
            h3r_name = f"{root}/hmmer/{seq_id}/{window}/{hit}/{profile}.h3r"
            blob = None
            if h3r_name in names:
                with zf.open(h3r_name) as f2:
                    blob = f2.read()
            prods.append(Prod(
                id=idx,
                seq_id=seq_id,
                window=window,
                window_interval=PyInterval(start=int(row["window_start"]),
                                           stop=int(row["window_stop"])),
                hit=hit,
                hit_interval=PyInterval(start=int(row["hit_start"]),
                                        stop=int(row["hit_stop"])),
                profile=profile,
                abc=row["abc"],
                lrt=float(row["lrt"]),
                evalue=float(row["evalue"]),
                match_list=MatchList.from_string(row["match"]),
                h3result_blob=blob,
            ))
        self._prods = ProdList(prods)

    @property
    def products(self) -> ProdList:
        return self._prods

    def __str__(self):
        n = len(self._prods)
        lines = [f"shape: ({n}, 11)"]
        for p in self._prods:
            lines.append(
                f"{p.id}\t{p.seq_id}\t{p.window}\t{p.profile}\t"
                f"lrt={p.lrt:.1f}\tevalue={p.evalue:.2g}")
        return "\n".join(lines)


def read_snap(filename) -> SnapFile:
    with zipfile.ZipFile(os.fspath(filename)) as zf:
        return SnapFile(zf)


def make_snap_archive(product_dir: str, dcs_path: str) -> str:
    """Zip a product directory into a .dcs archive.

    The directory's basename becomes the archive root (the reference zips
    NewSnapFile.basedir the same way, schema/__init__.py:221-226).
    """
    root = os.path.basename(os.path.normpath(product_dir))
    with zipfile.ZipFile(dcs_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, _dirnames, filenames in os.walk(product_dir):
            rel_dir = os.path.relpath(dirpath, product_dir)
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                arc = os.path.join(root, "" if rel_dir == "." else rel_dir, fn)
                zf.write(full, arc)
            if not filenames and rel_dir != ".":
                zf.writestr(os.path.join(root, rel_dir) + "/", "")
    return dcs_path
