"""The card's clocks, power and temperature beside the window, sampled by
``nvidia-smi`` once a second in a process of its own, started before the
window and stopped (and waited for) after it."""

import shutil
import statistics
import subprocess

FIELDS = ("name", "clocks.sm", "clocks.mem", "power.draw", "power.limit", "temperature.gpu")


class GpuSampler:
    def __init__(self, interval_ms: int = 1000):
        self.interval_ms, self.proc = interval_ms, None

    def start(self) -> None:
        exe = shutil.which("nvidia-smi")
        if exe is None:
            return
        self.proc = subprocess.Popen(
            [exe, f"--query-gpu={','.join(FIELDS)}", "--format=csv,noheader,nounits",
             "-lms", str(self.interval_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        """A summary of the samples: the card's name and power limit, and
        [min, median, max] of the SM and memory clocks (MHz), the power
        drawn (W) and the temperature (C)."""
        if self.proc is None:
            return {"samples": 0, "note": "nvidia-smi not found"}
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [[c.strip() for c in line.split(",")] for line in out.splitlines() if line.strip()]
        rows = [r for r in rows if len(r) == len(FIELDS)]
        summary = {"samples": len(rows)}
        if not rows:
            return summary
        summary.update(name=rows[0][0], power_limit_w=_number(rows[0][4]))
        for key, col in (("sm_clock_mhz", 1), ("mem_clock_mhz", 2), ("power_w", 3),
                         ("temperature_c", 5)):
            values = [v for v in (_number(r[col]) for r in rows) if v is not None]
            if values:
                summary[key] = [min(values), statistics.median(values), max(values)]
        return summary


def _number(text: str):
    try:
        return float(text)
    except ValueError:
        return None
