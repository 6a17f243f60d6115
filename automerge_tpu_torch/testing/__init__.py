"""Test-support utilities that ship with the port.

``automerge_tpu_torch.testing.faults`` is the fault-injection harness:
deterministic binary-change corrupters plus the failure-point registry
that the farm, engine and sync layers consult (`fire`). Production modules
import only the near-zero-cost ``fire`` hook; everything else is test-side.
"""
