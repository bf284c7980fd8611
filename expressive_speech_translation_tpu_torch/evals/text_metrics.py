"""Text quality metrics: BLEU, chrF, token F1 (self-contained, no downloads;
the port's copy of the JAX package's ``evals/text_metrics.py``).

The reference's evaluation template calls BERTScore + SONAR (analyze_outputs.py
:92-109) which require downloadable models; these standard surface metrics run
hermetically and BLEU is the parity gate metric (BASELINE.md: ≤0.5 BLEU delta).
BLEU matches sacrebleu's default signature (4-gram, exp smoothing off, closest
effective order with epsilon) closely enough for relative comparison.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def sentence_bleu(hypothesis: str, references: Iterable[str], *, max_n: int = 4) -> float:
    """Corpus-style BLEU on one sentence (percent, 0-100)."""
    return corpus_bleu([hypothesis], [list(references)], max_n=max_n)


def corpus_bleu(
    hypotheses: Sequence[str], references_list: Sequence[Sequence[str]], *, max_n: int = 4
) -> float:
    """BLEU-4 with brevity penalty (percent, 0-100)."""
    matches = [0] * max_n
    totals = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, refs in zip(hypotheses, references_list):
        h = hyp.split()
        rs = [r.split() for r in refs]
        hyp_len += len(h)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            h_ng = _ngrams(h, n)
            best = Counter()
            for r in rs:
                r_ng = _ngrams(r, n)
                for ng, c in r_ng.items():
                    best[ng] = max(best[ng], c)
            matches[n - 1] += sum(min(c, best[ng]) for ng, c in h_ng.items())
            totals[n - 1] += max(len(h) - n + 1, 0)
    if hyp_len == 0:
        return 0.0
    log_precisions = []
    for m, t in zip(matches, totals):
        if t == 0:
            continue
        p = m / t if m > 0 else 1e-9  # epsilon smoothing for zero matches
        log_precisions.append(math.log(p))
    if not log_precisions:
        return 0.0
    geo = math.exp(sum(log_precisions) / len(log_precisions))
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * geo


def chrf(hypothesis: str, reference: str, *, n: int = 6, beta: float = 2.0) -> float:
    """chrF score (percent) — character n-gram F-beta."""
    def grams(s: str, order: int) -> Counter:
        s = s.replace(" ", "")
        return Counter(s[i:i + order] for i in range(len(s) - order + 1))

    precisions, recalls = [], []
    for order in range(1, n + 1):
        h, r = grams(hypothesis, order), grams(reference, order)
        overlap = sum((h & r).values())
        if sum(h.values()):
            precisions.append(overlap / sum(h.values()))
        if sum(r.values()):
            recalls.append(overlap / sum(r.values()))
    if not precisions or not recalls:
        return 0.0
    p, r = sum(precisions) / len(precisions), sum(recalls) / len(recalls)
    if p + r == 0:
        return 0.0
    b2 = beta * beta
    return 100.0 * (1 + b2) * p * r / (b2 * p + r)


def token_f1(hypothesis: str, reference: str) -> float:
    """Bag-of-tokens F1 in [0, 1]."""
    h, r = Counter(hypothesis.split()), Counter(reference.split())
    overlap = sum((h & r).values())
    if not overlap:
        return 0.0
    p = overlap / max(sum(h.values()), 1)
    rec = overlap / max(sum(r.values()), 1)
    return 2 * p * rec / (p + rec)
