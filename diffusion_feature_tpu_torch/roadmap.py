"""What is not ported yet raises ``NotImplementedError`` naming the
ROADMAP.md Queue A item that brings it."""

#: Queue A items the port's messages cite, by title.
QUEUE_A = {
    'Training and tasks': 10,
    'Multi-GPU': 11,
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md, Queue A "
                               f"item {QUEUE_A[item]}: '{item}')")
