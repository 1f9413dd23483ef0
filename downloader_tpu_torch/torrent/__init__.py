"""Pure-asyncio BitTorrent client.

Capability-equivalent to the reference's use of webtorrent
(upstream lib/download.js:9,19,43-123): download a torrent given a
magnet link, a ``.torrent`` URL, or a local ``.torrent`` file, into a target
directory, with progress reporting and the 240 s metadata/stall watchdog
semantics the reference builds around it.

Scope: the BitTorrent peer wire protocol with the extension protocol
(BEP 3/10), fast extension (BEP 6), metadata exchange (BEP 9), compact
peers v4/v6 (BEP 23/7), peer exchange (BEP 11), webseeds (BEP 19),
HTTP(S) and UDP trackers with scrape (BEP 15/48), mainline DHT peer
discovery (BEP 5), ``x.pe`` direct peers, MSE/PE stream encryption, a
uTP datagram transport (BEP 29, ``utp.py``) with TCP fallback policy,
and fast-resume sidecars (``resume.py``) — so magnet links resolve
through trackers, the DHT, or explicit peers, matching and exceeding
webtorrent's discovery/transport surface.  The package also includes a
:class:`Seeder` (webtorrent seeds as well as leeches) serving both
transports, which doubles as the hermetic swarm for tests.
"""

from .bencode import bdecode, bencode
from .client import TorrentClient, TorrentError
from .dht import DHTNode
from .magnet import MagnetLink, parse_magnet
from .metainfo import Metainfo, make_metainfo
from .seeder import Seeder

__all__ = [
    "bdecode",
    "bencode",
    "TorrentClient",
    "TorrentError",
    "DHTNode",
    "MagnetLink",
    "parse_magnet",
    "Metainfo",
    "make_metainfo",
    "Seeder",
]
