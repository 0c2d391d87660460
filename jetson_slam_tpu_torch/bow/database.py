"""Keyframe database: loop / relocalization candidate retrieval.

Port of ``jetson_slam_tpu/bow/database.py`` (host numpy, as there), the
replacement of src/KeyFrameDatabase.cpp with the reference's own data
structure: a per-word INVERTED FILE (KeyFrameDatabase.h `mvInvertedFile`,
one posting list per vocabulary word) plus sparse per-keyframe BoW vectors,
so memory is O(total observed words), independent of vocabulary size — a
1M-word ORBvoc fits (the previous dense (K, n_words) matrix could not).
Candidate selection (min common words via posting-list walks, 0.8*max-common
cut, min-score filter, covisibility-group accumulation, 0.75*best retention)
follows KeyFrameDatabase::DetectLoopCandidates (:80-201) /
DetectRelocalizationCandidates (:203-315).
"""
from __future__ import annotations

import numpy as np

from .vocabulary import Vocabulary


def _sparse_l1_score(wa, va, wb, vb):
    """DBoW2 L1 score between two L1-normalized sparse vectors:
    s = 1 - 0.5 * sum|a - b| = 0.5 * sum_common (|a| + |b| - |a - b|)
    for normalized non-negative vectors (TemplatedVocabulary::score)."""
    common, ia, ib = np.intersect1d(wa, wb, assume_unique=True,
                                    return_indices=True)
    if len(common) == 0:
        return 0.0
    a = va[ia]
    b = vb[ib]
    return float(0.5 * np.sum(np.abs(a) + np.abs(b) - np.abs(a - b)))


class KeyFrameDatabase:
    def __init__(self, vocab: Vocabulary, max_keyframes=1024):
        self.vocab = vocab
        self.max_keyframes = max_keyframes
        # sparse BoW per keyframe: kid -> (sorted unique word ids, weights)
        self._vec: dict = {}
        # inverted file: word id -> list of kids (reference mvInvertedFile)
        self._postings: dict = {}
        self.has = np.zeros(max_keyframes, bool)

    def add(self, kid: int, descriptors: np.ndarray):
        kid = int(kid)
        if self.has[kid]:
            self.erase(kid)
        words, weights = self.vocab.sparse_bow(descriptors)
        self._vec[kid] = (words, weights)
        for w in words:
            self._postings.setdefault(int(w), []).append(kid)
        self.has[kid] = True

    def erase(self, kid: int):
        kid = int(kid)
        self.has[kid] = False
        words, _ = self._vec.pop(kid, (np.array([], np.int64), None))
        for w in words:
            lst = self._postings.get(int(w))
            if lst is not None:
                try:
                    lst.remove(kid)
                except ValueError:
                    pass

    def bow_of(self, kid):
        """Sparse (words, weights) of a stored keyframe."""
        return self._vec[int(kid)]

    def score(self, kid_a, kid_b):
        wa, va = self._vec[int(kid_a)]
        wb, vb = self._vec[int(kid_b)]
        return _sparse_l1_score(wa, va, wb, vb)

    def _common_words(self, words, exclude=()):
        """#shared words per keyframe via the inverted file (the reference's
        posting-list walk, KeyFrameDatabase.cpp:90-110)."""
        counts = np.zeros(self.max_keyframes, np.int64)
        hit = [self._postings.get(int(w), ()) for w in words]
        flat = [k for lst in hit for k in lst]
        if flat:
            np.add.at(counts, np.asarray(flat, np.int64), 1)
        counts[~self.has] = 0
        for e in exclude:
            counts[e] = 0
        return counts

    def _group_accumulate(self, cand, scores, map_store):
        """Covisibility-group score accumulation + 0.75*best retention
        (KeyFrameDatabase.cpp:140-200).  All candidates' covisibility
        neighborhoods come from ONE batched (B, K, S) pass
        (covisible_neighbors_batch) instead of a full-table scan per
        candidate — at K near capacity the per-candidate scans dominated
        loop detection."""
        score_of = np.full(self.max_keyframes, -1.0)
        score_of[np.asarray(cand, np.int64)] = scores
        neighborhoods = map_store.covisible_neighbors_batch(cand, n=10)
        acc_scores = []
        best_of_group = []
        for c, s, neigh in zip(cand, scores, neighborhoods):
            gs = score_of[neigh] if len(neigh) else np.empty(0)
            in_cand = gs >= 0
            acc = s + gs[in_cand].sum()
            best_kf, best_s = int(c), s
            if in_cand.any():
                j = int(np.argmax(np.where(in_cand, gs, -1.0)))
                if gs[j] > best_s:
                    best_s, best_kf = gs[j], int(neigh[j])
            acc_scores.append(acc)
            best_of_group.append(best_kf)
        acc_scores = np.asarray(acc_scores)
        th = 0.75 * acc_scores.max()
        out = {best_of_group[i] for i in np.flatnonzero(acc_scores >= th)}
        return np.array(sorted(out), np.int64)

    def detect_loop_candidates(self, kid, min_score, connected, map_store):
        """KeyFrameDatabase::DetectLoopCandidates (KeyFrameDatabase.cpp:80-201).

        connected: covisible KF ids of `kid` (excluded from candidacy).
        Returns candidate KF ids (accumulated-score filtered).
        """
        words, weights = self._vec[int(kid)]
        common = self._common_words(words,
                                    exclude=[int(kid)] + list(connected))
        if common.max(initial=0) == 0:
            return np.array([], np.int64)
        min_common = int(0.8 * common.max())
        cand = np.flatnonzero(common > min_common)
        if len(cand) == 0:
            return np.array([], np.int64)
        scores = np.array([self.score(kid, c) for c in cand])
        keep = scores >= min_score
        cand, scores = cand[keep], scores[keep]
        if len(cand) == 0:
            return np.array([], np.int64)
        return self._group_accumulate(cand, scores, map_store)

    def detect_relocalization_candidates(self, descriptors, map_store):
        """KeyFrameDatabase::DetectRelocalizationCandidates (:203-315)."""
        words, weights = self.vocab.sparse_bow(descriptors)
        common = self._common_words(words)
        if common.max(initial=0) == 0:
            return np.array([], np.int64)
        min_common = int(0.8 * common.max())
        cand = np.flatnonzero(common > min_common)
        if len(cand) == 0:
            return np.array([], np.int64)
        scores = np.array([
            _sparse_l1_score(words, weights, *self._vec[int(c)])
            for c in cand])
        return self._group_accumulate(cand, scores, map_store)
