"""The untraced window's training rate, QA of every step issued over the
window closed by a synchronise (what ``train_qa_per_s`` measures), in a
cell whose rate the host paces and whose runs spread too widely for an
end-to-end bound."""


def read(ctx):
    if ctx.window.get("qa", 0) == 0:
        return None
    return ctx.window["qa"] / ctx.window["seconds"]
