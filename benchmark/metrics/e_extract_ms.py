"""e_extract_ms (ms a job, host clock): the pipeline's ``E_extract`` stage
(pipeline.LAST_STAGES.times): every sample's FASTQ parsed, scored against
its group's differential k-mers and its selected reads written, averaged
over the window's jobs."""


def read(run):
    if not run.done:
        return None
    return 1e3 * sum(r["extract"] for r in run.done) / len(run.done)
