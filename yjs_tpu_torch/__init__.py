"""y-tpu: a TPU-native shared-editing CRDT framework.

Public API surface mirrors the reference's export contract
(reference src/index.js:2-76): Doc, the shared types, struct/content
classes, update/state-vector codecs (V1+V2), snapshots, undo manager,
relative positions, and helpers — plus the batch extensions
(``merge_updates``/``diff_update``) that feed the TPU engine.

Camel-case aliases are provided for the most common entry points so code
written against the JS API maps 1:1.
"""

from .coding import (  # noqa: F401
    DSDecoderV1,
    DSDecoderV2,
    DSEncoderV1,
    DSEncoderV2,
    UpdateDecoderV1,
    UpdateDecoderV2,
    UpdateEncoderV1,
    UpdateEncoderV2,
    use_v1_encoding,
    use_v2_encoding,
)
from .core import (  # noqa: F401
    GC,
    AbstractStruct,
    ContentAny,
    ContentBinary,
    ContentDeleted,
    ContentDoc,
    ContentEmbed,
    ContentFormat,
    ContentJSON,
    ContentString,
    ContentType,
    DeleteItem,
    DeleteSet,
    Doc,
    Item,
    StructStore,
    Transaction,
    add_to_delete_set,
    create_delete_set,
    create_delete_set_from_struct_store,
    find_index_ss,
    generate_new_client_id,
    get_item,
    get_state,
    get_state_vector,
    is_deleted,
    is_parent_of,
    iterate_deleted_structs,
    log_type,
    merge_delete_sets,
    read_delete_set,
    sort_and_merge_delete_set,
    transact,
    try_gc,
    write_delete_set,
)
from .ids import ID, compare_ids, create_id, find_root_type_key  # noqa: F401
from .types import (  # noqa: F401
    AbstractType,
    YArray,
    YArrayEvent,
    YEvent,
    YMap,
    YMapEvent,
    YText,
    YTextEvent,
    YXmlElement,
    YXmlEvent,
    YXmlFragment,
    YXmlHook,
    YXmlText,
)
from .types.abstract import get_type_children  # noqa: F401
from .types.abstract import (  # noqa: F401
    type_list_to_array_snapshot,
    type_map_get_snapshot,
)
from .types.ytext import cleanup_ytext_formatting  # noqa: F401
from .updates import (  # noqa: F401
    apply_update,
    apply_update_v2,
    convert_update_format,
    decode_state_vector,
    decode_state_vector_v2,
    diff_update,
    diff_update_v2,
    encode_state_as_update,
    encode_state_as_update_v2,
    encode_state_vector,
    encode_state_vector_from_update,
    encode_state_vector_v2,
    merge_updates,
    merge_updates_v2,
    read_update,
    read_update_v2,
)
from .utils.abstract_connector import AbstractConnector  # noqa: F401
from .utils.permanent_user_data import PermanentUserData  # noqa: F401
from .utils.relative_position import (  # noqa: F401
    AbsolutePosition,
    RelativePosition,
    compare_relative_positions,
    create_absolute_position_from_relative_position,
    create_relative_position_from_json,
    create_relative_position_from_type_index,
    decode_relative_position,
    encode_relative_position,
    read_relative_position,
    write_relative_position,
)
from .utils.snapshot import (  # noqa: F401
    Snapshot,
    create_doc_from_snapshot,
    create_snapshot,
    decode_snapshot,
    decode_snapshot_v2,
    empty_snapshot,
    encode_snapshot,
    encode_snapshot_v2,
    equal_snapshots,
    is_visible,
    snapshot,
)
from .utils.undo import UndoManager  # noqa: F401

__version__ = "0.1.0"

# -- camelCase + JS-name aliases (reference src/index.js:2-76 contract) -----
# pinned by tests/test_exports.py against the reference export list
Array = YArray
Map = YMap
Text = YText
XmlText = YXmlText
XmlHook = YXmlHook
XmlElement = YXmlElement
XmlFragment = YXmlFragment
applyUpdate = apply_update
applyUpdateV2 = apply_update_v2
readUpdate = read_update
readUpdateV2 = read_update_v2
encodeStateAsUpdate = encode_state_as_update
encodeStateAsUpdateV2 = encode_state_as_update_v2
encodeStateVector = encode_state_vector
encodeStateVectorV2 = encode_state_vector_v2
decodeStateVector = decode_state_vector
decodeStateVectorV2 = decode_state_vector_v2
mergeUpdates = merge_updates
mergeUpdatesV2 = merge_updates_v2
diffUpdate = diff_update
diffUpdateV2 = diff_update_v2
createDocFromSnapshot = create_doc_from_snapshot
cleanupYTextFormatting = cleanup_ytext_formatting
getTypeChildren = get_type_children
createRelativePositionFromTypeIndex = create_relative_position_from_type_index
createRelativePositionFromJSON = create_relative_position_from_json
createAbsolutePositionFromRelativePosition = (
    create_absolute_position_from_relative_position
)
compareRelativePositions = compare_relative_positions
writeRelativePosition = write_relative_position
readRelativePosition = read_relative_position
createID = create_id
compareIDs = compare_ids
getState = get_state
createSnapshot = create_snapshot
createDeleteSet = create_delete_set
createDeleteSetFromStructStore = create_delete_set_from_struct_store
emptySnapshot = empty_snapshot
findRootTypeKey = find_root_type_key
getItem = get_item
typeListToArraySnapshot = type_list_to_array_snapshot
typeMapGetSnapshot = type_map_get_snapshot
iterateDeletedStructs = iterate_deleted_structs
decodeSnapshot = decode_snapshot
encodeSnapshot = encode_snapshot
decodeSnapshotV2 = decode_snapshot_v2
encodeSnapshotV2 = encode_snapshot_v2
isDeleted = is_deleted
isParentOf = is_parent_of
equalSnapshots = equal_snapshots
tryGc = try_gc
logType = log_type
