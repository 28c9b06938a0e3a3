"""audio_s_per_s: seconds of audio of every clip completed in the window,
over the window, which spans whole calls (host clock)."""


def read(run):
    if run.kind != "t2a_closed" or not run.calls:
        return None
    return sum(c["audio_s"] for c in run.calls) / run.calls[-1]["end"]
