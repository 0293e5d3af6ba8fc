"""The scheduler REST service on the standard library HTTP stack.

Parity: sched/deciphon_sched — same route table (hmms/dbs/jobs/scans/seqs/
snap views/health, sched/__init__.py:6-20 + routers) with two structural
substitutions, both self-contained equivalents of external services:

  * artifact storage: instead of S3 presigned URLs, the service itself
    stores files under data_dir/files and the presigned-upload/-download
    endpoints return URLs pointing back at PUT/GET /files/{name}
    (the Poster client follows them identically);
  * job dispatch: instead of an MQTT broker, POST /hmms|/scans publish
    Press/ScanRequest payloads to a durable sqlite queue that workers
    long-poll via GET /queue/{topic} (journal parity:
    sched/journal.py:36-48).

FastAPI/uvicorn are not in this environment; a ThreadingHTTPServer with a
regex router serves the same single-node role.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pydantic import BaseModel, ValidationError

from ..schema import (Gencode, HMMName, JobState, PressRequest, ScanRequest,
                      SeqRead)
from .database import Database, JobStateTransitionError, NotFoundError
from .settings import SchedSettings
from .storage import Storage

__all__ = ["SchedServer"]


class ScanCreate(BaseModel):
    db_id: int
    multi_hits: bool
    hmmer3_compat: bool
    seqs: list[dict]


class HMMCreate(BaseModel):
    name: str
    gencode: int
    epsilon: float = 0.01


class DBCreate(BaseModel):
    name: str


class JobPatch(BaseModel):
    state: str
    progress: int = 0
    error: str = ""


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class SchedServer:
    """Owns the database, file storage, queue and the HTTP server."""

    ENDPOINTS = [
        "/", "/health", "/jobs", "/hmms", "/dbs", "/scans", "/seqs",
        "/files/{name}", "/queue/{topic}",
    ]

    def __init__(self, settings: SchedSettings | None = None):
        self.settings = settings or SchedSettings()
        import os

        os.makedirs(self.settings.data_dir, exist_ok=True)
        self.database = Database(self.settings.db_path)
        self.storage = Storage(self.settings.files_dir)
        self._routes = self._build_routes()
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer(
            (self.settings.host, self.settings.port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="sched")
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.database.close()

    def __enter__(self):
        self.serve_background()
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def url(self) -> str:
        return f"http://{self.settings.host}:{self.port}"

    # ------------------------------------------------------------------
    # Route handlers.  Each returns (status, body) where body is a python
    # object (JSON-encoded), bytes (raw), or None.
    # ------------------------------------------------------------------

    def _build_routes(self):
        db = self.database

        def dump(model):
            return json.loads(model.model_dump_json())

        # --- root / health
        def root(m):
            return 200, self.ENDPOINTS

        def health(m):
            return 200, {"status": "ok"}

        # --- files (the storage backend's wire surface)
        def file_put(m, body):
            self.storage.put(m["name"], body)
            return 201, None

        def file_get(m):
            try:
                return 200, self.storage.get(m["name"])
            except FileNotFoundError:
                raise _HTTPError(404, "file not found")

        # --- hmms
        def hmms_list(m):
            return 200, [dump(x) for x in db.hmms()]

        def hmm_presigned_upload(m):
            return 200, {"url": f"{self.url}/files/{m['name']}",
                         "method": "PUT", "fields": {}}

        def hmm_presigned_download(m):
            return 200, {"url": f"{self.url}/files/{m['name']}"}

        def hmm_create(m, body):
            req = HMMCreate.model_validate_json(body)
            hmm_name = HMMName(name=req.name)
            if not self.storage.exists(req.name):
                raise _HTTPError(412, f"{req.name} not uploaded yet")
            hmm = db.create_hmm(req.name)
            press = PressRequest.create(hmm.job.id, hmm_name,
                                        Gencode(req.gencode), req.epsilon)
            db.queue_publish("press", press.model_dump_json())
            return 201, dump(hmm)

        def hmm_get(m):
            return 200, dump(db.hmm_read(int(m["id"])))

        def hmm_delete(m):
            db.delete_hmm(int(m["id"]))
            return 204, None

        # --- dbs
        def dbs_list(m):
            return 200, [dump(x) for x in db.dbs()]

        def db_presigned_upload(m):
            return 200, {"url": f"{self.url}/files/{m['name']}",
                         "method": "PUT", "fields": {}}

        def db_presigned_download(m):
            return 200, {"url": f"{self.url}/files/{m['name']}"}

        def db_create(m, body):
            req = DBCreate.model_validate_json(body)
            if not self.storage.exists(req.name):
                raise _HTTPError(412, f"{req.name} not uploaded yet")
            return 201, dump(db.create_db(req.name))

        def db_get(m):
            return 200, dump(db.db_read(int(m["id"])))

        def db_delete(m):
            db.delete_db(int(m["id"]))
            return 204, None

        # --- jobs
        def jobs_list(m):
            return 200, [dump(x) for x in db.jobs()]

        def job_get(m):
            return 200, dump(db.job_read(int(m["id"])))

        def job_patch(m, body):
            req = JobPatch.model_validate_json(body)
            job = db.job_patch(int(m["id"]), JobState(req.state),
                               req.progress, req.error)
            return 200, dump(job)

        # --- scans
        def scans_list(m, query=None):
            job_id = None
            if query and "job_id" in query:
                job_id = int(query["job_id"])
            return 200, [dump(x) for x in db.scans(job_id)]

        def scan_create(m, body):
            req = ScanCreate.model_validate_json(body)
            seqs = [(s["name"], s["data"]) for s in req.seqs]
            scan = db.create_scan(req.db_id, req.multi_hits,
                                  req.hmmer3_compat, seqs)
            sreq = ScanRequest(
                id=scan.id, job_id=scan.job.id,
                hmm=scan.db.file.hmmname, db=scan.db.file,
                multi_hits=scan.multi_hits,
                hmmer3_compat=scan.hmmer3_compat,
                seqs=[SeqRead(id=s.id, name=s.name, data=s.data)
                      for s in scan.seqs])
            db.queue_publish("scan", sreq.model_dump_json())
            return 201, dump(scan)

        def scan_get(m):
            return 200, dump(db.scan_read(int(m["id"])))

        def scan_delete(m):
            db.delete_scan(int(m["id"]))
            return 204, None

        # --- snaps + views
        def snap_post(m, body):
            scan_id = int(m["id"])
            self._validate_snap(body)
            snap = db.put_snap(scan_id, body)
            db.job_patch(db.scan_read(scan_id).job.id, JobState.done)
            return 201, dump(snap)

        def snap_get(m):
            return 200, db.snap_data(int(m["id"]))

        def snap_delete(m):
            db.delete_snap(int(m["id"]))
            return 204, None

        def snap_view(kind):
            def handler(m):
                products = self._snap_products(int(m["id"]))
                if kind == "prods":
                    return 200, [
                        {"seq_id": p.seq_id, "profile": p.profile,
                         "abc": p.abc, "lrt": p.lrt, "evalue": p.evalue}
                        for p in products]
                if kind == "gff":
                    return 200, products.gff_list().format()
                if kind == "view":
                    from ..snap.view import view_alignments

                    return 200, view_alignments(products)
                elem = {"queries": "query", "states": "state",
                        "codons": "codon", "aminos": "amino"}[kind]
                return 200, products.fasta_list(elem).format()

            return handler

        # --- seqs
        def seqs_list(m):
            return 200, [dump(x) for x in db.seqs()]

        def seq_get(m):
            return 200, dump(db.seq_read(int(m["id"])))

        # --- queue long-poll
        def queue_next(m, query=None):
            timeout = float(query.get("timeout", "0")) if query else 0.0
            deadline = time.monotonic() + timeout
            while True:
                payload = db.queue_claim(m["topic"])
                if payload is not None:
                    return 200, json.loads(payload)
                if time.monotonic() >= deadline:
                    return 204, None
                time.sleep(0.1)

        R = []

        def add(method, pattern, fn, with_body=False, with_query=False):
            R.append((method, re.compile("^" + pattern + "$"), fn,
                      with_body, with_query))

        add("GET", r"/", root)
        add("GET", r"/health", health)
        add("PUT", r"/files/(?P<name>[^/]+)", file_put, with_body=True)
        add("GET", r"/files/(?P<name>[^/]+)", file_get)
        add("GET", r"/hmms", hmms_list)
        add("GET", r"/hmms/presigned-upload/(?P<name>[^/]+)",
            hmm_presigned_upload)
        add("GET", r"/hmms/presigned-download/(?P<name>[^/]+)",
            hmm_presigned_download)
        add("POST", r"/hmms/?", hmm_create, with_body=True)
        add("GET", r"/hmms/(?P<id>\d+)", hmm_get)
        add("DELETE", r"/hmms/(?P<id>\d+)", hmm_delete)
        add("GET", r"/dbs", dbs_list)
        add("GET", r"/dbs/presigned-upload/(?P<name>[^/]+)",
            db_presigned_upload)
        add("GET", r"/dbs/presigned-download/(?P<name>[^/]+)",
            db_presigned_download)
        add("POST", r"/dbs/?", db_create, with_body=True)
        add("GET", r"/dbs/(?P<id>\d+)", db_get)
        add("DELETE", r"/dbs/(?P<id>\d+)", db_delete)
        add("GET", r"/jobs", jobs_list)
        add("GET", r"/jobs/(?P<id>\d+)", job_get)
        add("PATCH", r"/jobs/(?P<id>\d+)", job_patch, with_body=True)
        add("GET", r"/scans", scans_list, with_query=True)
        add("POST", r"/scans/?", scan_create, with_body=True)
        add("GET", r"/scans/(?P<id>\d+)", scan_get)
        add("DELETE", r"/scans/(?P<id>\d+)", scan_delete)
        add("POST", r"/scans/(?P<id>\d+)/snap\.dcs", snap_post,
            with_body=True)
        add("GET", r"/scans/(?P<id>\d+)/snap\.dcs", snap_get)
        add("DELETE", r"/scans/(?P<id>\d+)/snap\.dcs", snap_delete)
        for kind in ("prods", "queries", "states", "codons", "aminos",
                     "gff", "view"):
            add("GET", rf"/scans/(?P<id>\d+)/snap\.dcs/{kind}",
                snap_view(kind))
        add("GET", r"/seqs", seqs_list)
        add("GET", r"/seqs/(?P<id>\d+)", seq_get)
        add("GET", r"/queue/(?P<topic>[^/]+)", queue_next, with_query=True)
        return R

    # ------------------------------------------------------------------
    def _validate_snap(self, body: bytes) -> None:
        """POST snap validation via read_snap (sched/scans.py:79-101)."""
        import io
        import zipfile

        from ..snap.snap_file import SnapFile

        try:
            with zipfile.ZipFile(io.BytesIO(body)) as zf:
                SnapFile(zf)
        except Exception as exc:
            raise _HTTPError(422, f"invalid snap: {exc}")

    def _snap_products(self, scan_id: int):
        import io
        import zipfile

        from ..snap.snap_file import SnapFile

        data = self.database.snap_data(scan_id)
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            return SnapFile(zf).products

    # ------------------------------------------------------------------
    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass  # quiet; errors are reported in responses

            def _dispatch(self, method):
                from urllib.parse import parse_qsl, urlparse

                parsed = urlparse(self.path)
                path = parsed.path.rstrip("/") or "/"
                query = dict(parse_qsl(parsed.query))
                for (m, rx, fn, with_body, with_query) in outer._routes:
                    if m != method:
                        continue
                    match = rx.match(path) or rx.match(parsed.path)
                    if not match:
                        continue
                    try:
                        args = [match.groupdict()]
                        if with_body:
                            n = int(self.headers.get("Content-Length", 0))
                            args.append(self.rfile.read(n))
                        if with_query:
                            status, body = fn(*args, query=query)
                        else:
                            status, body = fn(*args)
                    except _HTTPError as exc:
                        return self._send(exc.status,
                                          {"detail": exc.message})
                    except NotFoundError as exc:
                        return self._send(404, {"detail": str(exc)})
                    except JobStateTransitionError as exc:
                        return self._send(403, {"detail": str(exc)})
                    except (ValidationError, ValueError) as exc:
                        return self._send(422, {"detail": str(exc)})
                    except Exception as exc:  # pragma: no cover
                        return self._send(500, {"detail": repr(exc)})
                    return self._send(status, body)
                self._send(404, {"detail": "no such endpoint"})

            def _send(self, status, body):
                if body is None:
                    payload = b""
                    ctype = "application/json"
                elif isinstance(body, bytes):
                    payload = body
                    ctype = "application/octet-stream"
                elif isinstance(body, str):
                    payload = body.encode()
                    ctype = "text/plain; charset=utf-8"
                else:
                    payload = json.dumps(body).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                if outer.settings.allow_any_origin:
                    self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                if payload:
                    self.wfile.write(payload)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_PATCH(self):
                self._dispatch("PATCH")

            def do_DELETE(self):
                self._dispatch("DELETE")

        return Handler


def main():  # pragma: no cover - thin CLI wrapper
    import click

    @click.command()
    @click.option("--host", default=None)
    @click.option("--port", type=int, default=None)
    @click.option("--data-dir", default=None)
    def serve(host, port, data_dir):
        s = SchedSettings()
        if host:
            s.host = host
        if port is not None:
            s.port = port
        if data_dir:
            s.data_dir = data_dir
        server = SchedServer(s)
        click.echo(f"sched listening on {server.url}")
        server.serve_forever()

    serve()


if __name__ == "__main__":  # pragma: no cover
    main()
