from .protocol import (  # noqa: F401
    MESSAGE_YJS_SYNC_STEP_1,
    MESSAGE_YJS_SYNC_STEP_2,
    MESSAGE_YJS_UPDATE,
    read_sync_message,
    read_sync_step1,
    read_sync_step2,
    write_sync_step1,
    write_sync_step2,
    write_update,
)
from .session import (  # noqa: F401
    CONNECTING,
    LAGGING,
    LIVE,
    MESSAGE_YTPU_SESSION,
    RECONNECTING,
    SYNCING,
    CLOSED,
    DocSessionHost,
    SessionConfig,
    SessionMetrics,
    SyncSession,
)
from .transport import (  # noqa: F401
    CallbackTransport,
    PipeNetwork,
    PipeTransport,
    Transport,
)
