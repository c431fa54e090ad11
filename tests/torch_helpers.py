"""The port's copy of ``tests/helpers.py``: the same connector and
oracles over ``yjs_tpu_torch``.

Multi-client simulation without a network + replica-equality oracle.

Ports the reference's test strategy (SURVEY.md §4, reference
tests/testHelper.js): an in-memory connector buffers per-sender messages,
delivers them in PRNG-chosen random order through the real sync protocol,
and can disconnect/reconnect random clients.  ``compare()`` is the
gold-standard convergence check (struct-by-struct store identity).
"""

from __future__ import annotations

import random

import yjs_tpu_torch as Y
from yjs_tpu_torch.core import (
    Item,
    create_delete_set_from_struct_store,
    get_state_vector,
)
from yjs_tpu_torch.ids import compare_ids
from yjs_tpu_torch.lib0.decoding import Decoder
from yjs_tpu_torch.lib0.encoding import Encoder
from yjs_tpu_torch.lib0.u16 import to_u16
from yjs_tpu_torch.sync import protocol as sync


def broadcast_message(y: "TestYInstance", m: bytes) -> None:
    if y in y.tc.online_conns:
        for remote in list(y.tc.online_conns):
            if remote is not y:
                remote._receive(m, y)


class TestYInstance(Y.Doc):
    def __init__(self, test_connector: "TestConnector", client_id: int):
        super().__init__()
        self.user_id = client_id
        self.tc = test_connector
        self.receiving: dict[TestYInstance, list[bytes]] = {}
        test_connector.all_conns.add(self)

        def _on_update(update, origin, _doc):
            if origin is not test_connector:
                encoder = Encoder()
                sync.write_update(encoder, update)
                broadcast_message(self, encoder.to_bytes())

        self.on("update", _on_update)
        self.connect()

    def disconnect(self) -> None:
        self.receiving = {}
        self.tc.online_conns.discard(self)

    def connect(self) -> None:
        if self not in self.tc.online_conns:
            self.tc.online_conns.add(self)
            encoder = Encoder()
            sync.write_sync_step1(encoder, self)
            broadcast_message(self, encoder.to_bytes())
            for remote in list(self.tc.online_conns):
                if remote is not self:
                    enc = Encoder()
                    sync.write_sync_step1(enc, remote)
                    self._receive(enc.to_bytes(), remote)

    def _receive(self, message: bytes, remote_client: "TestYInstance") -> None:
        self.receiving.setdefault(remote_client, []).append(message)


class TestConnector:
    def __init__(self, gen: random.Random):
        self.all_conns: set[TestYInstance] = set()
        self.online_conns: set[TestYInstance] = set()
        self.prng = gen

    def create_y(self, client_id: int) -> TestYInstance:
        return TestYInstance(self, client_id)

    def flush_random_message(self) -> bool:
        gen = self.prng
        conns = sorted(
            (c for c in self.online_conns if c.receiving),
            key=lambda c: c.user_id,
        )
        if conns:
            receiver = gen.choice(conns)
            sender, messages = gen.choice(
                sorted(receiver.receiving.items(), key=lambda e: e[0].user_id)
            )
            m = messages.pop(0)
            if not messages:
                del receiver.receiving[sender]
            encoder = Encoder()
            # replies produced while processing are not re-broadcast
            sync.read_sync_message(Decoder(m), encoder, receiver, receiver.tc)
            if len(encoder) > 0:
                sender._receive(encoder.to_bytes(), receiver)
            return True
        return False

    def flush_all_messages(self) -> bool:
        did_something = False
        while self.flush_random_message():
            did_something = True
        return did_something

    def reconnect_all(self) -> None:
        for conn in list(self.all_conns):
            conn.connect()

    def disconnect_all(self) -> None:
        for conn in list(self.all_conns):
            conn.disconnect()

    def sync_all(self) -> None:
        self.reconnect_all()
        self.flush_all_messages()

    def disconnect_random(self) -> bool:
        if not self.online_conns:
            return False
        self.prng.choice(sorted(self.online_conns, key=lambda c: c.user_id)).disconnect()
        return True

    def reconnect_random(self) -> bool:
        reconnectable = sorted(
            (c for c in self.all_conns if c not in self.online_conns),
            key=lambda c: c.user_id,
        )
        if not reconnectable:
            return False
        self.prng.choice(reconnectable).connect()
        return True


def init(gen: random.Random, users: int = 5):
    """Build N synced clients; the encoding version (V1/V2) is chosen at
    random for the whole run (reference testHelper.js:233-263)."""
    result = {"users": []}
    if gen.random() < 0.5:
        Y.use_v2_encoding()
    else:
        Y.use_v1_encoding()
    test_connector = TestConnector(gen)
    result["testConnector"] = test_connector
    for i in range(users):
        y = test_connector.create_y(i)
        y.client_id = i
        result["users"].append(y)
        result[f"array{i}"] = y.get_array("array")
        result[f"map{i}"] = y.get_map("map")
        result[f"xml{i}"] = y.get("xml", Y.YXmlElement)
        result[f"text{i}"] = y.get_text("text")
    test_connector.sync_all()
    Y.use_v1_encoding()
    return result


def compare_item_ids(a, b) -> bool:
    return a is b or (a is not None and b is not None and compare_ids(a.id, b.id))


def compare_struct_stores(ss1, ss2) -> None:
    """Struct-by-struct identity + linked-list invariants
    (reference testHelper.js:326-363)."""
    assert len(ss1.clients) == len(ss2.clients)
    for client, structs1 in ss1.clients.items():
        structs2 = ss2.clients.get(client)
        assert structs2 is not None and len(structs1) == len(structs2)
        for s1, s2 in zip(structs1, structs2):
            assert type(s1) is type(s2)
            assert compare_ids(s1.id, s2.id)
            assert s1.deleted == s2.deleted, (s1.id, s1.deleted, s2.deleted)
            assert s1.length == s2.length
            if type(s1) is Item:
                assert type(s2) is Item
                assert (s1.left is None and s2.left is None) or (
                    s1.left is not None
                    and s2.left is not None
                    and compare_ids(s1.left.last_id, s2.left.last_id)
                )
                assert compare_item_ids(s1.right, s2.right)
                assert compare_ids(s1.origin, s2.origin)
                assert compare_ids(s1.right_origin, s2.right_origin)
                assert s1.parent_sub == s2.parent_sub
                assert s1.left is None or s1.left.right is s1
                assert s1.right is None or s1.right.left is s1
                assert s2.left is None or s2.left.right is s2
                assert s2.right is None or s2.right.left is s2


def compare_ds(ds1, ds2) -> None:
    assert len(ds1.clients) == len(ds2.clients)
    for client, delete_items1 in ds1.clients.items():
        delete_items2 = ds2.clients.get(client)
        assert delete_items2 is not None and len(delete_items1) == len(delete_items2)
        for d1, d2 in zip(delete_items1, delete_items2):
            assert d1.clock == d2.clock and d1.len == d2.len


def compare(users: list[TestYInstance]) -> None:
    """Reconnect, flush to quiescence, then assert full replica equality
    (reference testHelper.js:274-313)."""
    for u in users:
        u.connect()
    while users[0].tc.flush_all_messages():
        pass
    user_array_values = [u.get_array("array").to_json() for u in users]
    user_map_values = [u.get_map("map").to_json() for u in users]
    user_xml_values = [u.get("xml", Y.YXmlElement).to_string() for u in users]
    user_text_values = [u.get_text("text").to_delta() for u in users]
    for u in users:
        assert len(u.store.pending_delete_readers) == 0
        assert len(u.store.pending_stack) == 0
        assert len(u.store.pending_clients_struct_refs) == 0
    # array iterator agrees with to_array
    assert users[0].get_array("array").to_array() == list(users[0].get_array("array"))
    # map iterator agrees with to_json
    ymap_keys = list(users[0].get_map("map").keys())
    assert len(ymap_keys) == len(user_map_values[0])
    for key in ymap_keys:
        assert key in user_map_values[0]
    map_res = {
        k: (v.to_json() if isinstance(v, Y.AbstractType) else v)
        for k, v in users[0].get_map("map")
    }
    assert user_map_values[0] == map_res
    for i in range(len(users) - 1):
        assert len(user_array_values[i]) == users[i].get_array("array").length
        assert user_array_values[i] == user_array_values[i + 1]
        assert user_map_values[i] == user_map_values[i + 1]
        assert user_xml_values[i] == user_xml_values[i + 1]
        assert (
            sum(
                len(to_u16(a["insert"])) if isinstance(a["insert"], str) else 1
                for a in user_text_values[i]
            )
            == users[i].get_text("text").length
        )
        assert user_text_values[i] == user_text_values[i + 1]
        assert get_state_vector(users[i].store) == get_state_vector(users[i + 1].store)
        compare_ds(
            create_delete_set_from_struct_store(users[i].store),
            create_delete_set_from_struct_store(users[i + 1].store),
        )
        compare_struct_stores(users[i].store, users[i + 1].store)
    for u in users:
        u.destroy()


def apply_random_tests(
    gen: random.Random, mods, iterations: int, users: int = 5, compare_fn=None
):
    """Randomized convergence fuzzing (reference testHelper.js:398-423):
    random partitions, random delivery order, random mutations.

    ``compare_fn`` overrides the final oracle (default: full struct-store
    identity via :func:`compare`).  Op tables that mix in undo/redo need a
    content-level oracle instead: ``redone`` pointers are local-only state
    (reference Item.js mergeWith requires ``redone === null``), so the
    undoing replica legitimately merges differently than its peers."""
    result = init(gen, users=users)
    test_connector = result["testConnector"]
    users_list = result["users"]
    for _ in range(iterations):
        if gen.randint(0, 100) <= 2:
            # 2% chance to disconnect/reconnect a random user
            if gen.random() < 0.5:
                test_connector.disconnect_random()
            else:
                test_connector.reconnect_random()
        elif gen.randint(0, 100) <= 1:
            test_connector.flush_all_messages()
        elif gen.randint(0, 100) <= 50:
            test_connector.flush_random_message()
        user = users_list[gen.randint(0, len(users_list) - 1)]
        mod = gen.choice(mods)
        mod(user, gen)
    (compare_fn or compare)(users_list)
    return result
