"""Section timers + logo, mirroring the reference's raii_messenger
(src/jpezy.hpp:388-432) and disp_logo (src/jpezy.hpp:20-29)."""
from __future__ import annotations

import time


def disp_logo() -> None:
    print("   _")
    print("  (_)_ __   ___ _____   _")
    print("  | | '_ \\ / _ \\_  / | | | ")
    print("  | | |_) |  __// /| |_| |")
    print(" _/ | .__/ \\___/___|\\__, |")
    print("|__/|_|             |___/\ton tpu")
    print()


class SectionTimer:
    """Prints '<msg> ' on start and 'Done! Processing time: X(sec)' on stop.

    stop() returns elapsed seconds; restart() begins a new section.
    """

    def __init__(self, message: str, indent: str = ""):
        self._indent = indent
        self._stopped = False
        print(f"{indent}{message} ", end="", flush=True)
        self._t0 = time.time()

    def restart(self, message: str | None = None) -> None:
        if self._stopped:
            if message is not None:
                print(message)
            self._t0 = time.time()
            self._stopped = False

    def stop(self) -> float:
        if self._stopped:
            return 0.0
        dt = round(time.time() - self._t0, 3)
        print(f"{self._indent}Done! Processing time: {dt}(sec)")
        self._stopped = True
        return dt

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
