from .resourceapplier import ResourceApplier, ApplierOptions  # noqa: F401
from .snapshot import SnapshotService, SnapshotOptions  # noqa: F401
from .reset import ResetService  # noqa: F401
from .recorder import RecorderService  # noqa: F401
from .replayer import ReplayerService  # noqa: F401
from .importer import OneShotImporter  # noqa: F401
from .syncer import SyncerService  # noqa: F401
from .resourcewatcher import ResourceWatcherService  # noqa: F401
