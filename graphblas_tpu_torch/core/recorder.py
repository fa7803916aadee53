"""Recorder: capture the engine operations issued by a region of code.

Counterpart of ``graphblas_tpu/core/recorder.py``: python-graphblas records C
calls as GraphBLAS C text through a ContextVar; here, as in the reference,
the recorded lines are engine-op invocations (op family, operator, operand
names), written by ``core.base.record_call``, the same strings as the
reference's.
"""

import contextvars

_recorder = contextvars.ContextVar("recorder", default=None)


def record(opname, details):
    rec = _recorder.get()
    if rec is not None and rec.is_recording:
        rec.data.append(f"{opname}({details});")


class Recorder:
    """Record engine calls.  Usable as a context manager or start/stop."""

    def __init__(self, *, start=True, max_rows=20):
        self.data = []
        self.max_rows = max_rows
        self._is_recording = False
        self._token = None
        if start:
            self.start()

    @property
    def is_recording(self):
        return self._is_recording

    def start(self):
        if not self._is_recording:
            self._is_recording = True
            self._token = _recorder.set(self)

    def stop(self):
        if self._is_recording:
            self._is_recording = False
            if self._token is not None:
                _recorder.reset(self._token)
                self._token = None

    def clear(self):
        self.data.clear()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    def __repr__(self):
        lines = self.data
        if len(lines) > self.max_rows:
            head = lines[: self.max_rows // 2]
            tail = lines[-(self.max_rows // 2) :]
            lines = [*head, f"... ({len(self.data) - len(head) - len(tail)} more)", *tail]
        status = "recording" if self._is_recording else "stopped"
        body = "\n".join(f"  {line}" for line in lines)
        return f"graphblas_tpu_torch.Recorder ({status})\n{body}"

    def _repr_markdown_(self):
        body = "\n".join(self.data)
        return f"```\n{body}\n```"


class skip_record:
    """Null-object recorder."""

    is_recording = False
    data = ()
