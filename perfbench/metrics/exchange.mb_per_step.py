"""exchange.mb_per_step: the halo bytes rank 0 sends a model step: the
``exchange_bytes`` of the port's ``sim.step.exchange`` spans (each halo
refresh of the sharded stepper, counted by the mesh) over the steps of
its ``sim.step`` spans, in 10^6 bytes. The spans live in rank 0's
process, which sums them into its trace's summary
(``drivers/process_mesh.py`` ``_exchange_sums``). None where the port
keeps no such span."""


def read(record):
    tr = record.trace
    if not tr or not tr.get("exchange_steps") or \
            not tr.get("exchange_bytes"):
        return None
    return tr["exchange_bytes"] / tr["exchange_steps"] / 1e6
