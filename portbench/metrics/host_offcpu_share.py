"""Over the lanes' work time (the program's ``stage.*`` spans less their
waits for the card), the share their threads spent off the CPU: wall
time less thread CPU time.  Outside a wait for the card this is mostly
waiting for the interpreter lock."""
import spans


def read(ctx):
    return spans.offcpu_share(ctx)
