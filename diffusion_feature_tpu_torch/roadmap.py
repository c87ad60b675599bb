"""What is not ported yet raises ``NotImplementedError`` naming the
ROADMAP.md Queue A item (a module) or Queue B item (a kernel) that brings
it."""

#: Queue A items the port's messages cite, by title.
QUEUE_A = {
    'Training and tasks': 10,
    'Multi-GPU': 11,
}
#: Queue B items ("Still to port") the port's messages cite, by title.
QUEUE_B = {
    'Int8 weight-only dense': 3,
}


def not_ported(what: str, item: str, queue: str = 'A') -> NotImplementedError:
    number = (QUEUE_A if queue == 'A' else QUEUE_B)[item]
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md, Queue {queue} "
                               f"item {number}: '{item}')")
