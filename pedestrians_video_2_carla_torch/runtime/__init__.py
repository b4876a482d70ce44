"""Host-side runtime: the native batch loader, the background prefetcher
and the resident epoch runner (``resident_scan``)."""
from .native_loader import BinarySubsetCache, native_loader_available
from .prefetcher import DevicePrefetcher, device_put
