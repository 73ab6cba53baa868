"""R3 fixture (suppressed): a tolerated racy read, with a reason."""
import threading


class Engine:
    """A monitoring read that tolerates staleness suppresses R3."""

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
        """Racy-by-design monitoring read."""
        # pbcheck: disable=R3 (monitoring read; stale len is acceptable)
        return len(self.rounds)
