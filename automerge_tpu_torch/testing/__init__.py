"""Test-support utilities that ship with the port.

``automerge_tpu_torch.testing.faults`` is the fault-injection harness:
deterministic binary-change corrupters plus the failure-point registry
that the farm, engine and sync layers consult (`fire`). Production modules
import only the near-zero-cost ``fire`` hook; everything else is test-side.

``automerge_tpu_torch.testing.chaos`` is the chaos transport: a seeded
simulated network (drop/duplicate/reorder/corrupt/truncate/delay,
partitions, peer restarts) plus the ManualClock and harness that drive
supervised sync sessions through it in simulated time. It consults the
same failure-point registry (``chaos.send``/``chaos.deliver``), so network
chaos and merge faults compose.
"""
