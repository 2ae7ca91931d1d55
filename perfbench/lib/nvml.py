"""The card's own energy counter, ``nvmlDeviceGetTotalEnergyConsumption``
(millijoules since the NVIDIA kernel module loaded; Volta and later), read with
``ctypes`` as the port's ``telemetry/drift.py`` ``NvmlSource`` reads it.
Where the library or the counter cannot be read, it raises: there is no
modelled fallback."""
from __future__ import annotations

import ctypes


class EnergyCounter:
    def __init__(self, index: int = 0, library: str = "libnvidia-ml.so.1"):
        lib = ctypes.CDLL(library)
        self._lib = lib
        init, by_index = lib.nvmlInit_v2, lib.nvmlDeviceGetHandleByIndex_v2
        self._energy = lib.nvmlDeviceGetTotalEnergyConsumption
        for fn in (init, by_index, self._energy):
            fn.restype = ctypes.c_int
        init.argtypes = []
        by_index.argtypes = [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        self._energy.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_ulonglong)]
        self._check(init(), "nvmlInit_v2")
        self._h = ctypes.c_void_p()
        self._check(by_index(int(index), ctypes.byref(self._h)),
                    f"nvmlDeviceGetHandleByIndex_v2({index})")
        self.read_j()

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"NVML {what} returned {rc}")

    def power_limit_w(self) -> float:
        """The enforced power limit (``nvmlDeviceGetEnforcedPowerLimit``)."""
        fn = self._lib.nvmlDeviceGetEnforcedPowerLimit
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        mw = ctypes.c_uint()
        self._check(fn(self._h, ctypes.byref(mw)),
                    "nvmlDeviceGetEnforcedPowerLimit")
        return mw.value / 1000.0

    def read_j(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self._energy(self._h, ctypes.byref(mj)),
                    "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1000.0
