"""The ``apply`` loop: one farm, the server, and one ``apply_changes``
call a step that carries every delivery of the step (a flush of its
clients' pending changes, or a round of a counter's actors), timed on the
host clock from the call to a synchronize after it returns."""
from __future__ import annotations

from harness import cells


def farm_count(stream) -> int:
    return 1


def build(cfg, mix, stream, device):
    """The server's farm; no sync."""
    from automerge_tpu_torch import TorchDocFarm

    return [TorchDocFarm(stream.docs, capacity=cfg["capacity"],
                         device=device)], None


class Driver(cells.Driver):
    def run_step(self, step) -> None:
        # one source keeps its order; several arrive in generation order
        idxs = step[0][1] if len(step) == 1 else sorted(
            i for _, part in step for i in part)
        if self.in_window:
            self.made.extend(idxs)
        self._apply(0, idxs, delivered=True)


ControlDriver = Driver
