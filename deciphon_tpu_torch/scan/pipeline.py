"""The scan pipeline on PyTorch: batched two-phase Viterbi over
(profile, window) pairs.

Counterpart of deciphon_tpu/scan/pipeline.py (Scanner.run, one device;
with the `confirmer` hook, `warmup`, checkpoint/resume, `should_stop`,
`progress` and `release`), with four engines (ScanConfig.engine):

  "kernels" (the default; the reference's "pallas"):
    phase 1 (device, batched, pipelined): null + alt costs of every
      in-flight (profile, window) pair — the score kernels (packed tiers
      B7 and B6 for small-K profiles, chain tier B3, gang B5, carry B8,
      classic B1, large-K B4) through the bucketed scheduler — then the
      LRT filter;
    phase 2 (device + host): the B2 path kernel and the device walk for
      every survivor, hit segmentation, ML codon/amino decode, product
      line; then the confirmer's e-values of the wave's hits (e.g.
      hmmer/forward.py NativeConfirmer, the amino Forward and posterior
      kernels, one launch a Kpad group), and the confirmed lines;
  "kernels-multi" (the reference's "pallas-multi"): "kernels" with every
    phase-1 wave split over all visible cards (BucketedPairScorer's
    `devices`, parallel/multidevice.py); on one card, or with
    ScanConfig.device "cpu", it is "kernels";
  "torch" (the reference's "jax"): TorchPairScorer, the lax.scan
    engine's counterpart in plain PyTorch, scores each wave when it is
    dispatched; its phase 2 runs viterbi_path_batch per (profile, padded
    length) group, then the device walk;
  "native": NativePairScorer (native/), the striped C++ CPU engine over
    host threads, scores each wave; its phase 2 is the torch engine's on
    ScanConfig.device.

Windows of one (profile, sequence) pair advance serially with last-hit
feedback (speculated ahead and rewound on a hit, exactly as the
reference); lines are written in (profile, sequence, window) order.
Decoder, ProductWriter, WindowCursor, Sequence and ScanMetrics are the
port's own copies of deciphon_tpu's.
"""

from __future__ import annotations

import functools
import logging
import math
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import states as st
from ..logging import ScanMetrics, get_logger
from ..ops.costs import ViterbiCosts, build_costs
from ..profile import FrameProfile
from ..scan.decoder import Decoder
from ..scan.product import ProductLine, ProductWriter
from ..scan.sequence import Sequence
from ..scan.window import WindowCursor

from ..ops import viterbi as vk
from ..ops.traceback import REWALKS, PathSteps
from .scheduler import (UPLOADS, BucketedPairScorer, DeviceSeqCodes,
                        PairItem, TorchPairScorer)

HMMER_MAX_AMINO = 100000  # c-core/thread.c:184

_state_name_cached = functools.lru_cache(maxsize=1 << 16)(st.state_name)


def lrt(null_cost: float, alt_cost: float) -> float:
    """LRT from min-plus costs (lrt.h: -2(null_loglik - alt_loglik))."""
    return 2.0 * (float(null_cost) - float(alt_cost))


ENGINES = ("kernels", "kernels-multi", "torch", "native")


@dataclass
class ScanConfig:
    multi_hits: bool = True
    hmmer3_compat: bool = False
    max_pairs: int = 256  # pairs in flight per scoring round
    # Window-chain speculation depth cap per (profile, sequence) cursor.
    spec_depth: int = 64
    # torch device of the scan: "cuda" (the kernels) or "cpu" (their
    # plain PyTorch versions)
    device: str = "cuda"
    # "kernels": BucketedPairScorer (the hand-written kernels on the card,
    # their plain versions on the CPU); "kernels-multi": the same over
    # every visible card (parallel/multidevice.py); "torch":
    # TorchPairScorer, the lax.scan engine's counterpart; "native":
    # NativePairScorer, the multithreaded C++ CPU engine, its phase 2 on
    # `device`
    engine: str = "kernels"
    # Thread count for the native engine only; 0 = all cores (the
    # reference's NUM_THREADS OpenMP fan-out, c-core/scan.c:137-160).
    num_threads: int = 0


class Scanner:
    """Scans sequence batches against a list of pressed profiles.

    `confirmer`, if given, is called as confirmer(protein_idx, amino_seq)
    and must return (logevalue, h3r_blob|None) — the hmmpgmd confirmation
    stage (c-core/hmmer.c; hmmer/forward.py NativeConfirmer.confirm or
    hmmer/client.py HMMERClient.confirm).  A wave's hits are confirmed
    together after its decode: a confirmer offering
    `confirm_many([(protein_idx, amino_seq)]) -> [(logevalue, blob)]`
    (itself, or the object of a bound `confirm`, as NativeConfirmer's)
    gets them in one call, any other callable one call a hit, in order.
    Without it, every LRT hit is kept and reported with evalue 1 (log 0).
    """

    def __init__(self, profiles: list[FrameProfile],
                 config: ScanConfig | None = None, confirmer=None,
                 abc_name: str = "dna", scorer=None):
        """`scorer` replaces the default BucketedPairScorer (which packs
        small-K profiles): a scorer, or a callable taking the per-profile
        costs and returning one, e.g. a BucketedPairScorer built with a
        `scorer_factory`, which keeps every profile in the plain
        buckets."""
        self.profiles = profiles
        self.config = config or ScanConfig()
        self.confirmer = confirmer
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ScanConfig(device={self.config.device!r}) but no CUDA "
                "device is available")
        self.abc_name = abc_name
        self.costs: list[ViterbiCosts] = [
            build_costs(p, self.config.multi_hits, self.config.hmmer3_compat)
            for p in profiles
        ]
        self._scorer_spec = scorer
        self.scorer = self._make_scorer()
        self._decoders: dict[int, Decoder] = {}
        self.progress_done = 0
        self.progress_total = 0
        self.metrics: ScanMetrics | None = None  # set per run()
        self._checkpoint = False
        self._dev_codes: DeviceSeqCodes | None = None  # set per run()

    def _make_scorer(self):
        if self.config.engine not in ENGINES:
            raise ValueError(f"ScanConfig(engine={self.config.engine!r}): "
                             f"expected one of {ENGINES}")
        scorer = self._scorer_spec
        if scorer is not None:
            return scorer(self.costs) if callable(scorer) else scorer
        if self.config.engine == "torch":
            return TorchPairScorer(self.costs, self.device)
        if self.config.engine == "native":
            from ..native import NativePairScorer

            return NativePairScorer(
                self.costs, self.device,
                nthreads=self.config.num_threads or None)
        if (self.config.engine == "kernels-multi"
                and self.device.type == "cuda"):
            # the device-parallel path: the same scheduler, phase-1 waves
            # split over every visible card (one card: the one-device path)
            return BucketedPairScorer(
                self.costs, self.device,
                devices=[torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())])
        return BucketedPairScorer(self.costs, self.device)

    def release(self) -> None:
        """Free what is held between runs: the per-bucket scorers (the
        profile tables on the device) and the decoder memos.  The next
        run() builds them again (the reference's uncached workload
        mode)."""
        self.scorer = None
        self._decoders.clear()

    class Interrupted(RuntimeError):
        pass

    def warmup(self, read_lengths: list[int] | None = None,
               reads_per_length: int = 1) -> float:
        """Scan synthetic random reads of the expected lengths once, so
        that a later scan's first wave finds the kernels built and loaded
        and the decoders and allocator warm.  Returns the wall seconds
        spent.  The chain tier pins its (cap, cmax, w) per scan from the
        first wave, so pass the read lengths of production (e.g.
        `read_lengths=[10000]`, `reads_per_length=8`).  The default is
        one full-window read per distinct core size plus a 10 knt read."""
        if read_lengths is None:
            read_lengths = sorted({
                min(p.core_size * 50, 100000) for p in self.profiles}
                | {10000})
        rng = np.random.default_rng(0)
        seqs = [
            Sequence.make(i * reads_per_length + j, f"warmup{i}.{j}",
                          "".join("ACGT"[b]
                                  for b in rng.integers(0, 4, size=n)))
            for i, n in enumerate(read_lengths)
            for j in range(reads_per_length)
        ]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            self.run(seqs, tmp + "/warmup")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @property
    def progress(self) -> int:
        """Percent of (profile, sequence) pairs finished in this run."""
        if not self.progress_total:
            return 0
        return 100 * self.progress_done // self.progress_total

    def _drop_codes(self) -> None:
        """Release the scan-resident device codes."""
        self.scorer.set_device_codes(None)
        self._dev_codes = None

    def run(self, sequences: list[Sequence], product_dir: str,
            checkpoint: bool = False, should_stop=None) -> str:
        """Scan `sequences`, write `product_dir`/products.tsv and return
        its path.  With `checkpoint`, finished (profile, sequence) pairs
        and their products are journaled as they complete and a rerun in
        the same directory resumes from the journal.  `should_stop()` is
        asked before every wave; when it returns true the scan raises
        Scanner.Interrupted.

        Every host second of the call lies in a span of `self.metrics`
        (ScanMetrics.timed: `run`, holding `setup`, `windowing`, and per
        wave `assemble`, `phase1_dispatch`, `phase1_collect`, `lrt`,
        `phase2_dispatch`, `phase2_fetch`, `phase2_decode` and the
        `refill` windowing, then `write` and `release`); its `counts` hold
        the run's launches, host waits and blocking transfers (`syncs`),
        staged uploads, re-walks and, on the card, allocator events."""
        self.metrics = m = ScanMetrics()
        with m.running(counters=lambda: _process_counts(self.device)):
            out = self._scan(sequences, product_dir, checkpoint, should_stop)
        log = get_logger("deciphon_tpu_torch.scan")
        if log.isEnabledFor(logging.INFO):
            log.info("scan done: %s counts %s longest %s", m.summary(),
                     m.counts, {k: round(v, 6) for k, v in
                                sorted(m.longest.items())})
        return out

    def _scan(self, sequences: list[Sequence], product_dir: str,
              checkpoint: bool, should_stop) -> str:
        m = self.metrics
        log = get_logger("deciphon_tpu_torch.scan")
        with m.timed("setup"):
            if self.scorer is None:  # released after an earlier run
                self.scorer = self._make_scorer()
            writer = ProductWriter(product_dir)
            self._checkpoint = checkpoint
            done_pairs: set[tuple[int, int]] = set()
            if checkpoint:
                done_pairs = writer.load_checkpoint()
                if done_pairs:
                    log.info("resuming scan: %d pairs already complete",
                             len(done_pairs))
            # scan-resident device codes: one upload per run
            with m.timed("seq_upload"):
                self._dev_codes = DeviceSeqCodes(sequences, self.device)
                self.scorer.set_device_codes(self._dev_codes)
            self.scorer.set_metrics(m)
            P, S = len(self.profiles), len(sequences)
            self.progress_total = max(P * S, 1)
            self.progress_done = 0

            # -- speculative window chains (see deciphon_tpu's pipeline) --
            cursors: dict[tuple[int, int], WindowCursor] = {}
            chains: dict[tuple[int, int], list[PairItem]] = {}
            depth: dict[tuple[int, int], int] = {}
            exhausted: set[tuple[int, int]] = set()
            finished: set[tuple[int, int]] = set()
            max_depth = max(1, self.config.spec_depth)

            for p in range(P):
                K = self.profiles[p].core_size
                for s in range(S):
                    if (p, s) in done_pairs:
                        self.progress_done += 1
                        continue
                    cur = WindowCursor(K, sequences[s].size)
                    cursors[(p, s)] = cur
                    chains[(p, s)] = []
                    depth[(p, s)] = min(max_depth, cur.estimate_windows())

        def refill(key) -> None:
            if key in exhausted or key in finished:
                return
            cur = cursors[key]
            chain = chains[key]
            while len(chain) < depth[key]:
                item = self._next_item(key[0], key[1], cur, sequences)
                if item is None:
                    exhausted.add(key)
                    break
                item.post_state = cur.state()
                chain.append(item)

        def finish_ready() -> None:
            for key in chains:
                if (key in exhausted and not chains[key]
                        and key not in finished):
                    finished.add(key)
                    self.progress_done += 1
                    if self._checkpoint:
                        writer.journal_pair_done(*key)

        with m.timed("windowing"):
            for key in chains:
                refill(key)
            finish_ready()

        cap = max(self.config.max_pairs * 8, P * 64)

        def assemble() -> list[PairItem]:
            # round-robin across (profile, sequence) chains
            wave: list[PairItem] = []
            pending = [iter(chains[key]) for key in sorted(chains)]
            while pending and len(wave) < cap:
                nxt = []
                for itr in pending:
                    for it in itr:
                        if not it.dispatched:
                            it.dispatched = True
                            wave.append(it)
                            nxt.append(itr)
                            break
                    if len(wave) >= cap:
                        break
                pending = nxt
            return wave

        def lrt_pass(items, scores) -> list[tuple[PairItem, float]]:
            """LRT filter of one collected wave; returns the survivors."""
            m.pairs_batches += 1
            survivors: list[tuple[PairItem, float]] = []
            for it in items:
                if not it.valid:
                    m.wasted_windows += 1
                    continue
                chains[(it.p_idx, it.s_idx)].remove(it)
                m.add_window(it.win.length, self.profiles[it.p_idx].core_size)
                null_c, alt_c = scores[id(it)]
                line_lrt = lrt(null_c, alt_c)
                if math.isfinite(line_lrt) and line_lrt >= 0:
                    survivors.append((it, line_lrt))
            return survivors

        def process(survivors, paths, k: int) -> None:
            rewound: dict = {}  # key -> rewind cutoff window idx
            queue: list = []  # the wave's lines awaiting confirmation
            with m.timed("phase2_decode", wave=k):
                for it, line_lrt in survivors:
                    key = (it.p_idx, it.s_idx)
                    if (not it.valid or (key in rewound
                                         and it.win.idx > rewound[key])):
                        m.wasted_windows += 1
                        continue
                    m.survivors += 1

                    def on_hit_pos(pos, it=it, key=key):
                        cur = cursors[key]
                        if pos == it.post_state[3]:
                            return  # speculation state already matches
                        # rewind to the exact post-hit serial state and
                        # discard every speculated later window
                        cur.restore(it.post_state)
                        cur.set_last_hit_position(pos)
                        for later in chains[key]:
                            later.valid = False
                        chains[key].clear()
                        exhausted.discard(key)
                        depth[key] = 1
                        rewound[key] = it.win.idx

                    self._phase2(it, sequences[it.s_idx], line_lrt,
                                 on_hit_pos, writer, paths[id(it)], queue)
                # before finish_ready journals a pair done: its confirmed
                # lines are journaled first
                with m.timed("confirm"):
                    self._confirm_wave(queue, writer)
            with m.timed("windowing", wave=k), m.timed("refill"):
                for key in chains:
                    if key not in rewound and depth[key] < max_depth:
                        depth[key] = min(depth[key] * 2, max_depth)
                    refill(key)
                finish_ready()

        # Wave k's phase-1 collect, then its path launches, then wave
        # k+1's phase-1 dispatch, then wave k's path fetch and decode: the
        # host decode overlaps the next wave's device work (on the card it
        # waits for a survivor's own path launch alone, PathSteps).
        inflight = None  # (handle, items, k) of the dispatched-ahead wave
        waves = 0  # index of the next wave assembled
        while True:
            if should_stop is not None and should_stop():
                # stop between waves; with checkpointing the journal
                # keeps the finished pairs for a later resume
                self._drop_codes()
                raise Scanner.Interrupted("scan interrupted")
            survivors, pend = [], []
            if inflight is not None:
                prev_handle, prev_items, k = inflight
                with m.timed("phase1_collect", wave=k):
                    scores = self.scorer.collect_all(prev_handle)
                with m.timed("lrt", wave=k):
                    survivors = lrt_pass(prev_items, scores)
                with m.timed("phase2_dispatch", wave=k):
                    pend = self._batched_paths_dispatch(survivors)
            with m.timed("assemble", wave=waves):
                wave = assemble()
            handle = None
            if wave:
                with m.timed("phase1_dispatch", wave=waves):
                    handle = self.scorer.dispatch_all(wave)
            if inflight is not None:
                with m.timed("phase2_fetch", wave=k):
                    paths = self._batched_paths_collect(pend)
                process(survivors, paths, k)
                del paths  # entries it never read hold wave k's trellis
            inflight = (handle, wave, waves) if wave else None
            waves += bool(wave)
            if inflight is None and not any(chains.values()):
                break

        with m.timed("write"):
            writer.sort_lines()
            m.products = len(writer.lines)
            out = writer.close()
        with m.timed("release"):
            self._drop_codes()
        return out

    def _next_item(self, p: int, s: int, cur: WindowCursor,
                   sequences) -> PairItem | None:
        win = cur.next()
        if win is None:
            return None
        return PairItem(
            p_idx=p, s_idx=s, win=win, seq=sequences[s],
            gstart=self._dev_codes.gstart(s, win.start),
            multi_hits=self.config.multi_hits,
            hmmer3_compat=self.config.hmmer3_compat,
        )

    def _decoder(self, p_idx: int) -> Decoder:
        if p_idx not in self._decoders:
            self._decoders[p_idx] = Decoder(self.profiles[p_idx])
        return self._decoders[p_idx]

    def _batched_paths_dispatch(self, survivors) -> list:
        """Launch the trellis + device walk for every LRT survivor of one
        wave without fetching; returns the un-fetched path entries (and
        at most one dict of results the scorer collected early)."""
        return self.scorer.paths_dispatch([it for it, _ in survivors])

    def _batched_paths_collect(self, entries) -> PathSteps:
        """{id(item) -> (sids, sizes)} of every entry (a dict among the
        entries holds results collected early): on the CPU fetched in ONE
        host transfer and assembled now; on the card each entry's staged
        steps are read when the decode first asks for one of its
        survivors, after that entry's own event."""
        return PathSteps(entries, self.metrics)

    def _phase2(self, it: PairItem, seq: Sequence, line_lrt: float,
                on_hit_pos, writer: ProductWriter, path: tuple,
                queue: list) -> None:
        p_idx, win = it.p_idx, it.win
        profile = self.profiles[p_idx]
        sids_all, sizes_all = path  # (n,) int64 arrays, S..T order

        seg = segment_hits(sids_all, sizes_all)
        if seg is None:
            return  # no B state: cursor's last_hit_pos stays -1
        begin, end, hit_start, hit_stop, last_hit_pos, found_hit = seg
        on_hit_pos(last_hit_pos)
        if not found_hit:
            return  # B without E: empty amino -> no product

        window_syms = seq.data[win.start:win.stop]
        decoder = self._decoder(p_idx)
        pos0 = int(sizes_all[:begin].sum())

        # fragment codes from the window's END-indexed code table (code of
        # the fragment ending at e with duration d sits at codes[e-1, d-1])
        sids = sids_all[begin:end]
        sizes = sizes_all[begin:end]
        ends = pos0 + np.cumsum(sizes)
        starts_rel = ends - sizes
        cls = sids >> 14
        is_x = cls == 3
        mute = (cls == 2) | (is_x & (np.isin(sids & 0x3FFF,
                                             (st.STATE_S & 0x3FFF,
                                              st.STATE_B & 0x3FFF,
                                              st.STATE_E & 0x3FFF,
                                              st.STATE_T & 0x3FFF))))
        emit = (~mute) & (sizes > 0)
        codes_win = it.codes  # (L, 5) END-indexed window fragment codes
        emit_pos = np.nonzero(emit)[0]
        fcs = codes_win[ends[emit_pos] - 1, sizes[emit_pos] - 1]

        names = [_state_name_cached(int(s)) for s in sids]
        frags = [window_syms[s:e] for s, e in zip(starts_rel, ends)]
        steps = [f + "," + nm + ",," for f, nm in zip(frags, names)]
        aminos: list[str] = []
        for i, (codon, amino) in zip(
                emit_pos,
                decoder.decode_batch([int(sids[i]) for i in emit_pos],
                                     fcs)):
            steps[i] = f"{frags[i]},{names[i]},{codon},{amino}"
            aminos.append(amino)
        amino_seq = "".join(aminos)
        if self.confirmer is None and not amino_seq:
            return  # with a confirmer, an empty hit goes to it

        line = ProductLine(
            sequence=seq.id, window=win.idx, window_start=win.start,
            window_stop=win.stop, hit=0, hit_start=hit_start,
            hit_stop=hit_stop, profile=profile.accession, abc=self.abc_name,
            lrt=line_lrt, logevalue=0.0, steps=steps)
        order = (p_idx, seq.id, win.idx)
        # HMMER3 can't confirm >100k aminos: past HMMER_MAX_AMINO only the
        # confirmation is skipped and the line is still written
        # (thread.c:182-207 — add_match is outside the guard)
        if (self.confirmer is not None
                and len(amino_seq) + 1 <= HMMER_MAX_AMINO):
            queue.append((line, order, (p_idx, it.s_idx), amino_seq))
            return
        self._add_line(writer, line, order, (p_idx, it.s_idx))

    def _add_line(self, writer: ProductWriter, line: ProductLine,
                  order: tuple, pair: tuple) -> None:
        writer.add(line, order=order)
        if self._checkpoint:
            writer.journal_line(line, order, pair)

    def _confirm_wave(self, queue: list, writer: ProductWriter) -> None:
        """Confirm the wave's queued lines (thread.c:182-207): in one
        confirm_many call where the confirmer offers it, else one call a
        hit; then, in queue order, drop a line whose log-E is 0 (after
        clamping a positive one) and write the rest with their h3r."""
        if not queue:
            return
        hits = [(order[0], amino_seq) for _, order, _, amino_seq in queue]
        many = confirm_many_of(self.confirmer)
        answers = (many(hits) if many is not None
                   else [self.confirmer(p, q) for p, q in hits])
        if len(answers) != len(queue):
            raise ValueError(f"the confirmer answered {len(answers)} of "
                             f"{len(queue)} hits")
        for (line, order, pair, _), (logevalue, blob) in zip(queue, answers):
            if logevalue > 0:
                logevalue = 0.0
            if logevalue == 0:
                continue
            line.logevalue = logevalue
            if blob is not None:
                writer.add_h3r(line, blob)
            self._add_line(writer, line, order, pair)


def _process_counts(device: torch.device) -> dict:
    """The process-wide counts a run's `counts` take the differences of:
    kernel launches by wrapper (ops/viterbi.py LAUNCHES, the one counting
    site), streamed table bytes (UPLOADS), re-walked survivors (REWALKS)
    and, on the card, the caching allocator's retries, device mallocs and
    frees."""
    out = {"launches": dict(vk.LAUNCHES), "h2d_bytes": UPLOADS["bytes"],
           "rewalks": REWALKS["survivors"]}
    if device.type == "cuda":
        mem = torch.cuda.memory_stats(device)
        out.update(alloc_retries=mem.get("num_alloc_retries", 0),
                   device_mallocs=mem.get("num_device_alloc", 0),
                   device_frees=mem.get("num_device_free", 0))
    return out


def confirm_many_of(confirmer):
    """The batched hook of a confirmer: its own `confirm_many`, or that of
    the object whose bound `confirm` it is; None for any other callable."""
    many = getattr(confirmer, "confirm_many", None)
    if many is None and getattr(confirmer, "__name__", None) == "confirm":
        many = getattr(getattr(confirmer, "__self__", None), "confirm_many",
                       None)
    return many


def segment_hits(sids: np.ndarray, sizes: np.ndarray):
    """Hit segmentation over a traced path (c-core/thread.c:130-166).

    Takes the path as (n,) int64 arrays in S..T order.  Returns
    (begin_idx, end_idx, hit_start, hit_stop, last_hit_pos, found_hit)
    over the span from the first B to one past the last E, or None when
    no B state exists.  hit_start/hit_stop are window-relative nucleotide
    positions; last_hit_pos is hit_stop-1 once a B was seen.
    """
    b_idx = np.nonzero(sids == st.STATE_B)[0]
    if len(b_idx) == 0:
        return None
    begin = int(b_idx[0])
    hit_start = int(sizes[:begin].sum())

    e_idx = np.nonzero(sids[begin + 1:] == st.STATE_E)[0]
    if len(e_idx) == 0:
        return begin, begin + 1, hit_start, hit_start, hit_start - 1, False
    last_e = begin + 1 + int(e_idx[-1])
    hit_stop = hit_start + int(sizes[begin + 1:last_e].sum())
    return begin, last_e + 1, hit_start, hit_stop, hit_stop - 1, True
