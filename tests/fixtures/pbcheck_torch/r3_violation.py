"""R3 fixture: a thread-shared attribute read outside the lock."""
import threading


class Engine:
    """Background fill thread mutates ``rounds``; a reader skips the
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.rounds = []

    def start(self):
        """Spawn the fill thread."""
        t = threading.Thread(target=self._run, daemon=True)
        t.start()

    def _run(self):
        while not self._stop.is_set():
            self.load()

    def load(self):
        """One fill round (correctly locked)."""
        with self._lock:
            self.rounds.append(1)

    def status(self):
        """Unlocked read of the shared list — the R3 violation."""
        return len(self.rounds)
