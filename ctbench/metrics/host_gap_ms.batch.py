"""host_gap_ms.batch: the mean device-idle gap between one volume's last
device activity and the next volume's first, in ms: the host's work
before a volume's first kernel, and after its last, that the card waits
for."""


def read(run):
    if run.trace is None:
        return None
    groups = [g for g in run.trace.by_call() if g]
    gaps = [max(0.0, min(a.start for a in nxt) - max(a.end for a in prev))
            for prev, nxt in zip(groups, groups[1:])]
    if not gaps:
        return None
    return sum(gaps) / len(gaps) / 1e3
