"""PermanentUserData: user↔clientID/DeleteSet attribution stored inside a
shared YMap (reference src/utils/PermanentUserData.js).

The reference defers some writes with ``setTimeout(0)``; here they run
synchronously after the current transaction, which preserves convergence.
"""

from __future__ import annotations

from ..coding import DSDecoderV1, DSEncoderV1
from ..core import DeleteSet, is_deleted, merge_delete_sets, read_delete_set, write_delete_set
from ..ids import ID
from ..lib0.decoding import Decoder


class PermanentUserData:
    def __init__(self, doc, store_type=None):
        if store_type is None:
            store_type = doc.get_map("users")
        self.yusers = store_type
        self.doc = doc
        self.clients: dict[int, str] = {}
        self.dss: dict[str, DeleteSet] = {}

        def init_user(user, user_description):
            ds = user.get("ds")
            ids = user.get("ids")

            def add_client_id(clientid, *_args):
                self.clients[clientid] = user_description

            def _on_ds(event, _txn):
                for item in event.changes["added"]:
                    for encoded_ds in item.content.get_content():
                        if isinstance(encoded_ds, (bytes, bytearray)):
                            self.dss[user_description] = merge_delete_sets(
                                [
                                    self.dss.get(user_description, DeleteSet()),
                                    read_delete_set(DSDecoderV1(Decoder(bytes(encoded_ds)))),
                                ]
                            )

            ds.observe(_on_ds)
            self.dss[user_description] = merge_delete_sets(
                ds.map(
                    lambda encoded_ds, i, t: read_delete_set(
                        DSDecoderV1(Decoder(bytes(encoded_ds)))
                    )
                )
            )

            def _on_ids(event, _txn):
                for item in event.changes["added"]:
                    for clientid in item.content.get_content():
                        add_client_id(clientid)

            ids.observe(_on_ids)
            ids.for_each(add_client_id)

        def _on_users(event, _txn):
            for user_description in event.keys_changed:
                init_user(store_type.get(user_description), user_description)

        store_type.observe(_on_users)
        store_type.for_each(lambda user, key, _t: init_user(user, key))

    def set_user_mapping(self, doc, clientid: int, user_description: str, filter=None) -> None:
        """(reference PermanentUserData.js:77-120)."""
        from ..types.yarray import YArray
        from ..types.ymap import YMap

        if filter is None:
            filter = lambda _txn, _ds: True  # noqa: E731
        users = self.yusers
        user = users.get(user_description)
        if user is None:
            user = YMap()
            user.set("ids", YArray())
            user.set("ds", YArray())
            users.set(user_description, user)
        users.get(user_description).get("ids").push([clientid])

        state = {"user": users.get(user_description)}

        def _on_users(event, _txn):
            user_overwrite = users.get(user_description)
            if user_overwrite is not state["user"]:
                # user object was overwritten: port data to the new object
                user_local = user_overwrite
                state["user"] = user_local
                for cid, desc in list(self.clients.items()):
                    if user_description == desc:
                        user_local.get("ids").push([cid])
                encoder = DSEncoderV1()
                ds = self.dss.get(user_description)
                if ds:
                    write_delete_set(encoder, ds)
                    user_local.get("ds").push([encoder.to_bytes()])

        users.observe(_on_users)

        def _after_transaction(transaction, _doc):
            yds = state["user"].get("ds")
            ds = transaction.delete_set
            if transaction.local and ds.clients and filter(transaction, ds):
                encoder = DSEncoderV1()
                write_delete_set(encoder, ds)
                yds.push([encoder.to_bytes()])

        doc.on("afterTransaction", _after_transaction)

    def get_user_by_client_id(self, clientid: int) -> str | None:
        return self.clients.get(clientid)

    def get_user_by_deleted_id(self, id: ID) -> str | None:
        for user_description, ds in self.dss.items():
            if is_deleted(ds, id):
                return user_description
        return None
