"""A miniature collaboration server on the PyTorch port's Provider.

The port's copy of ``examples/server_demo.py``: N rooms whose tables
live on the CUDA device, two simulated Yjs-wire clients per room editing
concurrently, the y-protocols 3-message handshake for a late joiner,
typed change events, and rich exports — the end-to-end product loop.

    python examples/torch_server_demo.py                 # on the card
    python examples/torch_server_demo.py --device cpu    # plain kernels

Without ``--device cpu`` the provider wants the CUDA device and raises
when there is none.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import yjs_tpu_torch as Y  # noqa: E402
from yjs_tpu_torch.provider import TpuProvider  # noqa: E402


def main(n_rooms: int = 8, device: str | None = None) -> None:
    server = TpuProvider(n_docs=n_rooms, device=device)
    print(f"provider on {server.engine.device}")
    broadcasts: list[tuple[str, bytes]] = []
    server.on_update(lambda guid, u: broadcasts.append((guid, u)))
    server.observe(
        "room-0", ["text"],
        lambda guid, ev: print(f"  event {guid}: delta={ev['delta']}"),
    )

    # two clients per room edit concurrently, server integrates in batches
    clients = {}
    for r in range(n_rooms):
        guid = f"room-{r}"
        a = Y.Doc(gc=False); a.client_id = 100 + r
        b = Y.Doc(gc=False); b.client_id = 200 + r
        clients[guid] = (a, b)
        a.get_text("text").insert(0, f"[{guid}] alice says hi. ")
        b.get_text("text").insert(0, f"[{guid}] bob says yo. ")
        b.get_text("text").format(0, 5, {"bold": True})
        b.get_map("meta").set("topic", f"demo-{r}")
        for d in (a, b):
            server.receive_update(guid, Y.encode_state_as_update(d))
    server.flush()  # ONE batched device step for every room
    print(f"flushed {n_rooms} rooms: "
          f"{server.metrics['n_docs_flushed']} integrated, "
          f"{len(broadcasts)} update broadcasts queued")

    # keep the clients in sync from the server's broadcasts
    for guid, update in broadcasts:
        for d in clients[guid]:
            Y.apply_update(d, update)

    # a late joiner syncs with the y-protocols handshake: it announces its
    # (empty) state vector, the server answers with the missing diff
    from yjs_tpu_torch.lib0 import decoding
    from yjs_tpu_torch.lib0.decoding import Decoder
    from yjs_tpu_torch.lib0.encoding import Encoder
    from yjs_tpu_torch.sync import protocol

    joiner = Y.Doc(gc=False)
    e = Encoder()
    protocol.write_sync_step1(e, joiner)
    server_reply = server.handle_sync_message("room-0", e.to_bytes())
    d = Decoder(server_reply)
    assert decoding.read_var_uint(d) == protocol.MESSAGE_YJS_SYNC_STEP_2
    Y.apply_update(joiner, decoding.read_var_uint8_array(d))

    a, _b = clients["room-0"]
    assert joiner.get_text("text").to_string() == a.get_text("text").to_string()
    print(f"late joiner converged: {joiner.get_text('text').to_string()!r}")
    print(f"rich delta: {server.to_delta('room-0')}")
    print(f"meta: {server.engine.map_json(server.doc_id('room-0'), 'meta')}")
    print("demo OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="torch_server_demo", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rooms", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; by default "
                         "the CUDA device, and no card is an error")
    args = ap.parse_args()
    main(args.rooms, args.device)
