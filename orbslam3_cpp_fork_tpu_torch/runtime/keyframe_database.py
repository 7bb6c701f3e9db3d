"""Keyframe recognition database (port of runtime/keyframe_database.py;
KeyFrameDatabase + the DBoW2 vocabulary).

The vocabulary is built online: the first `n_words` descriptors the map
registers seed the codebook (a sample of the actual descriptor distribution,
drawn with the reference's numpy-seeded permutation), and `refresh_codebook`
re-trains it from the whole stored corpus with binary k-means and
re-histograms every stored keyframe. Scoring is the cosine of idf-weighted,
corpus-mean-centered word histograms; `query_groups` accumulates scores over
covisible groups (DetectNBestCandidates) and `adaptive_floor` is the
scene-adaptive candidate floor.

Everything is numpy on the host except the word assignment: each
descriptor's nearest codebook word is a Hamming argmin (first index on ties)
on the database's device, so only the (N,) word ids are fetched.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import fetch_block
from ..ops import matching


def _nearest_words(desc_i8: torch.Tensor, codebook_i8: torch.Tensor) -> torch.Tensor:
    """Per-descriptor nearest codebook word (first index on ties)."""
    return torch.argmin(matching.hamming_matrix(desc_i8, codebook_i8), dim=1)


N_WORDS = 1024

# The Atlas's keyframes share one database: a row is a (map, keyframe slot)
# pair, `map_id % MAX_MAPS * max_keyframes + slot`. Map ids MAX_MAPS apart
# share a namespace (the reference's layout, ROADMAP R16).
MAX_MAPS = 16


def row_of(map_id: int, k: int, max_k: int) -> int:
    """The database row of keyframe slot k of map `map_id`."""
    return map_id % MAX_MAPS * max_k + int(k)


def split_row(g: int, max_k: int) -> tuple[int, int]:
    """(map namespace, keyframe slot) of a database row."""
    return int(g) // max_k, int(g) % max_k


class KeyFrameDatabase:
    def __init__(self, max_keyframes: int, device: torch.device, n_words: int = N_WORDS, seed: int = 0):
        self.n_words = n_words
        self._seed = seed
        # Device of the word-assignment argmin (the tracker's).
        self.device = torch.device(device)
        self.codebook: np.ndarray | None = None  # (W,256) int8
        self._cb_j = None
        self._pool: list[np.ndarray] = []
        self._pool_count = 0
        self._pending: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.hists = np.zeros((max_keyframes, n_words), np.float32)
        self.present = np.zeros(max_keyframes, bool)
        # Per-keyframe packed descriptors (uint8 (N,32)) + validity:
        # the corpus refresh_codebook re-trains from and re-histograms.
        self._desc_store: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.n_refreshes = 0
        # The database is shared across the tracking, mapping and
        # loop-closing threads (add/erase from loop + culling, queries
        # from relocalization and detection, refresh from map spawns) —
        # one lock serializes every public operation; each costs
        # single-digit milliseconds.
        self._lock = threading.RLock()

    # ------------------------------------------------------------------

    def _maybe_build_codebook(self):
        if self.codebook is not None or self._pool_count < self.n_words:
            return
        pool = np.concatenate(self._pool)
        rng = np.random.default_rng(self._seed)
        sel = rng.permutation(len(pool))[: self.n_words]
        self.codebook = pool[sel].astype(np.int8)
        self._cb_j = self._put(self.codebook)
        self._pool = []
        # Flush keyframes added before the vocabulary existed.
        for k, (d, v) in list(self._pending.items()):
            self.hists[k] = self._hist(d, v)
            self.present[k] = True
        self._pending.clear()

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _words(self, desc_i8: np.ndarray, codebook: torch.Tensor) -> np.ndarray:
        return fetch_block([_nearest_words(self._put(desc_i8), codebook)])[0]

    def _hist(self, desc_i8: np.ndarray, valid: np.ndarray) -> np.ndarray:
        words = self._words(desc_i8, self._cb_j)
        h = np.zeros(self.n_words, np.float32)
        np.add.at(h, words[valid], 1.0)
        return h

    # ------------------------------------------------------------------

    def histogram(self, desc_i8: np.ndarray, valid: np.ndarray) -> np.ndarray | None:
        """Word histogram of a frame, or None while the online vocabulary
        is still collecting descriptors."""
        with self._lock:
            if self.codebook is None:
                return None
            return self._hist(desc_i8, valid)

    def add(self, k: int, desc_i8: np.ndarray, valid: np.ndarray,
            hist: np.ndarray | None = None):
        """Register a keyframe. Pass `hist` (from `histogram`) to reuse
        an already-computed signature — callers that both query and add
        the same frame would otherwise pay the device round trip twice."""
        with self._lock:
            self._desc_store[k] = (
                np.packbits(
                    desc_i8.astype(np.uint8), axis=-1, bitorder="little"
                ),
                valid.copy(),
            )
            if self.codebook is None:
                d = desc_i8[valid]
                self._pool.append(d.copy())
                self._pool_count += len(d)
                self._pending[k] = (desc_i8.copy(), valid.copy())
                self._maybe_build_codebook()
                return
            self.hists[k] = (
                self._hist(desc_i8, valid) if hist is None else hist
            )
            self.present[k] = True

    def erase(self, k: int):
        with self._lock:
            self.present[k] = False
            self.hists[k] = 0.0
            self._pending.pop(k, None)
            self._desc_store.pop(k, None)

    def clear(self):
        with self._lock:
            self.present[:] = False
            self.hists[:] = 0.0
            self._pending.clear()
            self._desc_store.clear()

    def refresh_codebook(self, lloyd_iters: int = 1, sample_cap: int = 65536):
        """Re-train the vocabulary from the WHOLE accumulated corpus and
        re-histogram every stored keyframe.

        Centers are re-sampled uniformly from all stored descriptors,
        then refined with binary k-means: assign every corpus descriptor
        to its nearest center (Hamming), re-estimate each center as the
        majority bit of its members. Empty clusters keep their previous
        center. The reference tracker calls this when a new Atlas map spawns (a
        new scene is coming; the old first-seconds sample must not
        serve it forever)."""
        with self._lock:
            return self._refresh_codebook_locked(lloyd_iters, sample_cap)

    def _refresh_codebook_locked(self, lloyd_iters: int, sample_cap: int):
        if not self._desc_store:
            return
        packs = []
        for d, v in self._desc_store.values():
            packs.append(d[v])
        corpus_p = np.concatenate(packs)
        if len(corpus_p) < self.n_words:
            return
        rng = np.random.default_rng(self._seed + 1 + self.n_refreshes)
        if len(corpus_p) > sample_cap:
            corpus_p = corpus_p[
                rng.permutation(len(corpus_p))[:sample_cap]
            ]
        corpus = np.unpackbits(
            corpus_p, axis=-1, bitorder="little"
        ).astype(np.int8)
        centers = corpus[rng.permutation(len(corpus))[: self.n_words]]
        cb_dev = self._put(centers)
        for _ in range(max(lloyd_iters, 0)):
            words = self._words(corpus, cb_dev)
            sums = np.zeros((self.n_words, 256), np.int32)
            np.add.at(sums, words, corpus)
            counts = np.bincount(words, minlength=self.n_words)
            upd = counts > 0
            centers[upd] = (
                sums[upd] * 2 > counts[upd, None]
            ).astype(np.int8)
            cb_dev = self._put(centers)
        self.codebook = centers
        self._cb_j = cb_dev
        self.n_refreshes += 1
        # Re-histogram every stored keyframe against the new vocabulary.
        for k, (d, v) in self._desc_store.items():
            bits = np.unpackbits(d, axis=-1, bitorder="little").astype(np.int8)
            self.hists[k] = self._hist(bits, v)
            self.present[k] = True
        self._pending.clear()

    # ------------------------------------------------------------------

    def query(
        self,
        hist: np.ndarray,
        exclude: np.ndarray | None = None,
        n_best: int = 3,
        min_score: float = 0.03,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-n keyframes by idf-weighted centered cosine similarity,
        excluding the given set (the reference excludes the query's
        covisibility group, src/KeyFrameDatabase.cc:629)."""
        with self._lock:
            if self.codebook is None or not self.present.any():
                return np.zeros(0, np.int64), np.zeros(0, np.float32)
            rows = np.nonzero(self.present)[0]
            scores = self._scores(hist, rows)
        if exclude is not None and len(exclude):
            scores[np.isin(rows, np.asarray(exclude, np.int64))] = -1.0
        order = np.argsort(-scores)[:n_best]
        keep = scores[order] > min_score
        return rows[order[keep]], scores[order][keep]

    def _scores(self, hist: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """idf-weighted centered cosine of `hist` against the present
        rows (everything sized by n_present, NOT the keyframe capacity —
        full-capacity traversals cost ~40 ms per query at 16k slots)."""
        P = self.hists[rows]
        mean = P.mean(axis=0)
        df = (P > 0).sum(axis=0)
        idf = np.log((1.0 + len(P)) / (1.0 + df)).astype(np.float32)
        e = (hist - mean) * idf
        q = e / max(np.linalg.norm(e), 1e-9)
        emb = (P - mean) * idf
        norms = np.maximum(np.linalg.norm(emb, axis=1), 1e-9)
        return (emb @ q) / norms

    def adaptive_floor(
        self, hist: np.ndarray, exclude=None, z: float = 2.0,
        min_n: int = 8,
    ) -> float | None:
        """Scene-adaptive candidate-score floor: robust outlier bound
        (median + z * 1.4826*MAD) of the query's scores against the
        non-excluded database rows. A true revisit is, by construction,
        an extreme outlier of the aliasing-score distribution, and the
        bound tracks that distribution wherever it moves — measured on
        the test ring, refresh_codebook shifts the true-revisit score
        0.21 -> 0.13 while aliases move 0.01 -> 0.05; any absolute cut
        that admits one rejects the other. This serves the same role as
        the reference's relative minScore (derived from the query's
        covisible neighbors, DetectLoopCandidates
        src/KeyFrameDatabase.cc:92-115); the neighbor-minimum form
        itself doesn't transfer to the centered idf-cosine signature,
        whose scores for partially-overlapping neighbors sit inside
        the alias band. Returns None below min_n scorable rows (caller
        falls back to a fixed floor)."""
        with self._lock:
            if self.codebook is None or not self.present.any():
                return None
            rows = np.nonzero(self.present)[0]
            scores = self._scores(hist, rows)
        if exclude is not None and len(exclude):
            scores = scores[~np.isin(rows, np.asarray(exclude, np.int64))]
        if len(scores) < min_n:
            return None
        med = float(np.median(scores))
        mad = float(np.median(np.abs(scores - med)))
        return med + z * 1.4826 * max(mad, 1e-4)

    def query_groups(
        self,
        hist: np.ndarray,
        covis,
        exclude: np.ndarray | None = None,
        n_best: int = 3,
        min_score: float = 0.03,
        shared_word_frac: float = 0.8,
        acc_frac: float = 0.75,
    ) -> tuple[np.ndarray, np.ndarray]:
        """DetectNBestCandidates semantics (src/KeyFrameDatabase.cc:
        609-741): gate candidates by shared words (> shared_word_frac x
        the maximum), score, then ACCUMULATE each candidate's score over
        its top covisibles that also matched the query, and return the
        best-scoring member of each of the top groups (keeping groups
        within acc_frac of the best accumulated score). Group
        accumulation is what makes retrieval robust to single-frame
        aliasing. `covis(row) -> iterable of covisible rows` is supplied
        by the caller (the database spans Atlas maps; covisibility
        lives in each map's graph)."""
        with self._lock:
            if self.codebook is None or not self.present.any():
                return np.zeros(0, np.int64), np.zeros(0, np.float32)
            rows = np.nonzero(self.present)[0]
            sub_scores = self._scores(hist, rows)
            shared_sub = (self.hists[rows] > 0).astype(np.float32) @ (
                hist > 0
            ).astype(np.float32)
        if exclude is not None and len(exclude):
            sub_scores[np.isin(rows, np.asarray(exclude, np.int64))] = -1.0
        # Global-row score lookup for the covisible-group accumulation.
        scores = np.full(self.hists.shape[0], -1.0, np.float32)
        scores[rows] = sub_scores

        shared_sub[sub_scores < 0] = 0
        mx = shared_sub.max() if len(shared_sub) else 0.0
        if mx < 1:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        cand = rows[
            (shared_sub > shared_word_frac * mx) & (sub_scores > min_score)
        ]
        if len(cand) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        cand_set = set(int(c) for c in cand)
        groups = []  # (acc_score, best_row, best_score)
        for c in cand:
            members = [int(c)] + [
                int(g) for g in covis(int(c)) if int(g) in cand_set
            ]
            acc = float(sum(scores[g] for g in members))
            best = max(members, key=lambda g: scores[g])
            groups.append((acc, int(best), float(scores[best])))
        groups.sort(key=lambda t: -t[0])
        best_acc = groups[0][0]
        out, out_s, seen = [], [], set()
        for acc, best, sc in groups:
            if acc < acc_frac * best_acc or len(out) >= n_best:
                break
            if best in seen:
                continue
            seen.add(best)
            out.append(best)
            out_s.append(sc)
        return np.asarray(out, np.int64), np.asarray(out_s, np.float32)
