"""Host waits on the card per DCP train step: cudaStreamSynchronize,
cudaDeviceSynchronize and cudaEventSynchronize calls between the train
pass's mark and the test pass's mark, over the train steps."""


def read(d):
    train, test = d["marks"].get("train"), d["marks"].get("eval")
    if not train or not test or not d.get("train_steps"):
        return None
    return sum(1 for s in d["syncs"] if train[0] <= s < test[0]) / d["train_steps"]
