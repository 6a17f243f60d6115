"""The benchmark harness of automerge_tpu_torch: traffic generation, the
window drivers, the reduction of spans and traces to metrics, and the
output check. It takes from the port only the system under test
(``TorchDocFarm``, ``SyncFarm``) and its spans and kernel names."""
