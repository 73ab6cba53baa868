"""R3 fixture (clean): every shared access goes through the lock."""
import threading


class Engine:
    """Same shape as the violating fixture but lock-disciplined."""

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
        """One fill round (locked)."""
        with self._lock:
            self.rounds.append(1)

    def status(self):
        """Locked read of the shared list."""
        with self._lock:
            return len(self.rounds)
