// Port copy of hotstuff_tpu/store/native/engine.cpp, with the same C ABI
// and the same on-disk records; built by hotstuff_tpu_torch/utils/kernel_build.py
// (build_native) into hotstuff_tpu_torch/_build/, never beside this file.
//
// Native log-structured KV engine for the hotstuff_tpu store.
//
// The reference wraps RocksDB behind a single-writer actor
// (store/src/lib.rs); this is the TPU-era equivalent for the runtime's
// native plane: an append-only log with an in-memory hash index, sharing
// the exact on-disk record format of the Python LogEngine
// (u32 klen, u32 vlen, key, value — little-endian), so the two engines
// are interchangeable on the same database directory.
//
// Concurrency model: one writer (the store actor / event loop). The C API
// is deliberately single-threaded, like the actor that owns it.
//
// Crash behavior: torn tail records are detected and dropped on replay;
// an optional fsync knob covers power-crash durability for meta records.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>     // open (directory fsync)
#include <sys/stat.h>  // stat
#include <unistd.h>    // truncate, fsync, close

extern "C" {

struct HsStore {
    std::unordered_map<std::string, std::string> index;
    FILE* log = nullptr;
    std::string path;
    std::string error;
    // Writes arriving while a compaction rewrite runs on another thread
    // are mirrored here and appended to the tmp file at commit, so the
    // atomic replace never discards records the index already holds.
    bool compacting = false;
    std::vector<std::pair<std::string, std::string>> delta;
};

static int64_t file_bytes(const std::string& path) {
    struct stat st;
    if (::stat(path.c_str(), &st) != 0) return 0;
    return static_cast<int64_t>(st.st_size);
}

// Best-effort directory fsync, same discipline as the Python engine's
// MetaLog._fsync_dir: without it a rename can be lost on power failure.
static void fsync_dir(const std::string& file_path) {
    auto slash = file_path.find_last_of('/');
    std::string dir = slash == std::string::npos ? "." : file_path.substr(0, slash);
    int fd = ::open(dir.c_str(), O_RDONLY);
    if (fd < 0) return;
    ::fsync(fd);  // unsupported on some filesystems: best effort
    ::close(fd);
}

static bool replay(HsStore* s, const std::string& path) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return true;  // fresh database
    std::fseek(f, 0, SEEK_END);
    long file_size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    long valid_end = 0;  // offset just past the last complete record
    for (;;) {
        uint32_t hdr[2];
        size_t n = std::fread(hdr, 1, sizeof hdr, f);
        if (n < sizeof hdr) break;  // clean EOF or torn header: stop
        // Bound lengths by the remaining file size before allocating: a
        // torn header can decode to multi-GB lengths and bad_alloc must
        // not escape the C ABI.
        long remaining = file_size - std::ftell(f);
        if (remaining < 0 ||
            static_cast<uint64_t>(hdr[0]) + hdr[1] >
                static_cast<uint64_t>(remaining))
            break;  // torn record: stop
        std::string key(hdr[0], '\0'), val(hdr[1], '\0');
        if (std::fread(key.data(), 1, hdr[0], f) != hdr[0]) break;
        if (std::fread(val.data(), 1, hdr[1], f) != hdr[1]) break;
        s->index[std::move(key)] = std::move(val);
        valid_end = std::ftell(f);
    }
    std::fseek(f, 0, SEEK_END);
    long file_end = std::ftell(f);
    std::fclose(f);
    if (file_end > valid_end) {
        // Torn tail: truncate before reopening for append, or the next
        // replay would misparse records written after the garbage bytes.
        if (truncate(path.c_str(), valid_end) != 0) return false;
    }
    return true;
}

HsStore* hs_store_open(const char* log_path) {
    auto* s = new HsStore();
    s->path = log_path;
    // A crash between the compaction tmp write and its rename leaves a
    // stale ``store.log.tmp`` beside the (intact) live log; discard it so
    // a later compaction cannot surface a file mixing two generations.
    std::remove((s->path + ".tmp").c_str());
    if (!replay(s, log_path)) {
        delete s;
        return nullptr;
    }
    s->log = std::fopen(log_path, "ab");
    if (!s->log) {
        delete s;
        return nullptr;
    }
    return s;
}

int hs_store_put(HsStore* s, const uint8_t* key, uint32_t klen,
                 const uint8_t* val, uint32_t vlen) {
    if (!s->log) {
        // A failed compaction swap can leave no append handle (reopen
        // after rename failed): retry here instead of dereferencing null,
        // so one transient failure doesn't poison every later write.
        s->log = std::fopen(s->path.c_str(), "ab");
        if (!s->log) return -1;
    }
    uint32_t hdr[2] = {klen, vlen};
    if (std::fwrite(hdr, 1, sizeof hdr, s->log) != sizeof hdr) return -1;
    if (std::fwrite(key, 1, klen, s->log) != klen) return -1;
    if (std::fwrite(val, 1, vlen, s->log) != vlen) return -1;
    if (std::fflush(s->log) != 0) return -1;
    std::string k(reinterpret_cast<const char*>(key), klen);
    std::string v(reinterpret_cast<const char*>(val), vlen);
    if (s->compacting) s->delta.emplace_back(k, v);
    s->index[std::move(k)] = std::move(v);
    return 0;
}

// Two-phase read: hs_store_get returns the value length (or -1 if absent);
// hs_store_read copies it out. The value cannot disappear between the two
// calls because the owning actor is single-threaded.
int64_t hs_store_get(HsStore* s, const uint8_t* key, uint32_t klen) {
    auto it = s->index.find(std::string(reinterpret_cast<const char*>(key), klen));
    if (it == s->index.end()) return -1;
    return static_cast<int64_t>(it->second.size());
}

int hs_store_read(HsStore* s, const uint8_t* key, uint32_t klen, uint8_t* out,
                  uint32_t outlen) {
    auto it = s->index.find(std::string(reinterpret_cast<const char*>(key), klen));
    if (it == s->index.end()) return -1;
    if (it->second.size() > outlen) return -2;
    std::memcpy(out, it->second.data(), it->second.size());
    return 0;
}

uint64_t hs_store_size(HsStore* s) { return s->index.size(); }

// Phased compaction: rewrite the log without the dropped keys (and
// without superseded duplicate records), atomically: tmp + fsync + rename
// + directory fsync — the same crash discipline as the Python
// LogEngine.compact. A crash at any point leaves either the old complete
// log or the new complete log.
//
// Split into begin/write/commit so the expensive part — writing every
// retained record plus the fsync — can run on a caller-provided thread
// while the owning event loop keeps serving puts: ``begin`` (owner
// thread) deep-copies the retained records and arms the delta mirror in
// hs_store_put; ``write`` touches ONLY its state object, so it is safe on
// any thread; ``commit``/``abort`` (owner thread again) append the
// mirrored delta, swap the files, and always leave a usable append handle
// (or null, which hs_store_put re-opens lazily).

struct HsCompact {
    std::vector<std::pair<std::string, std::string>> items;  // retained
    std::unordered_set<std::string> drop;
    std::string tmp;
};

// ``blob`` packs the drop set as repeated (u32 klen, key) entries.
// Returns null if the blob is malformed or a compaction is in flight.
HsCompact* hs_store_compact_begin(HsStore* s, const uint8_t* blob,
                                  uint64_t blob_len) {
    if (s->compacting) return nullptr;
    std::unordered_set<std::string> drop;
    uint64_t pos = 0;
    while (pos + 4 <= blob_len) {
        uint32_t klen;
        std::memcpy(&klen, blob + pos, 4);
        pos += 4;
        if (pos + klen > blob_len) return nullptr;  // malformed drop set
        drop.emplace(reinterpret_cast<const char*>(blob + pos), klen);
        pos += klen;
    }
    if (pos != blob_len) return nullptr;
    auto* c = new HsCompact();
    c->tmp = s->path + ".tmp";
    c->items.reserve(s->index.size());
    // Deep copies: the write thread must never touch the live index —
    // concurrent puts may rehash it or overwrite a value in place.
    for (const auto& kv : s->index) {
        if (drop.count(kv.first)) continue;
        c->items.emplace_back(kv.first, kv.second);
    }
    c->drop = std::move(drop);
    s->compacting = true;
    s->delta.clear();
    return c;
}

// Write the retained snapshot to the tmp file (flush + fsync). Reads only
// ``c`` — safe on any thread. Returns 0 on success, -1 on error.
int hs_store_compact_write(HsCompact* c) {
    FILE* f = std::fopen(c->tmp.c_str(), "wb");
    if (!f) return -1;
    for (const auto& kv : c->items) {
        uint32_t hdr[2] = {static_cast<uint32_t>(kv.first.size()),
                           static_cast<uint32_t>(kv.second.size())};
        if (std::fwrite(hdr, 1, sizeof hdr, f) != sizeof hdr ||
            std::fwrite(kv.first.data(), 1, kv.first.size(), f) !=
                kv.first.size() ||
            std::fwrite(kv.second.data(), 1, kv.second.size(), f) !=
                kv.second.size()) {
            std::fclose(f);
            std::remove(c->tmp.c_str());
            return -1;
        }
    }
    if (std::fflush(f) != 0 || ::fsync(fileno(f)) != 0) {
        std::fclose(f);
        std::remove(c->tmp.c_str());
        return -1;
    }
    std::fclose(f);
    return 0;
}

// Discard an in-flight compaction (write failure or shutdown): the live
// log was never touched.
void hs_store_compact_abort(HsStore* s, HsCompact* c) {
    s->compacting = false;
    s->delta.clear();
    std::remove(c->tmp.c_str());
    delete c;
}

// Append the delta mirrored during the rewrite, atomically swap the logs,
// drop the dead keys. Returns bytes reclaimed, or -1 on error — the old
// log stays live on every failure path, and the append handle is restored
// (or lazily re-opened by the next hs_store_put).
int64_t hs_store_compact_commit(HsStore* s, HsCompact* c) {
    FILE* f = std::fopen(c->tmp.c_str(), "ab");
    if (!f) {
        hs_store_compact_abort(s, c);
        return -1;
    }
    for (const auto& kv : s->delta) {
        if (c->drop.count(kv.first)) continue;
        uint32_t hdr[2] = {static_cast<uint32_t>(kv.first.size()),
                           static_cast<uint32_t>(kv.second.size())};
        if (std::fwrite(hdr, 1, sizeof hdr, f) != sizeof hdr ||
            std::fwrite(kv.first.data(), 1, kv.first.size(), f) !=
                kv.first.size() ||
            std::fwrite(kv.second.data(), 1, kv.second.size(), f) !=
                kv.second.size()) {
            std::fclose(f);
            hs_store_compact_abort(s, c);
            return -1;
        }
    }
    if (std::fflush(f) != 0 || ::fsync(fileno(f)) != 0) {
        std::fclose(f);
        hs_store_compact_abort(s, c);
        return -1;
    }
    std::fclose(f);
    const int64_t before = file_bytes(s->path);
    std::fclose(s->log);
    s->log = nullptr;
    if (std::rename(c->tmp.c_str(), s->path.c_str()) != 0) {
        s->log = std::fopen(s->path.c_str(), "ab");  // old log survived
        hs_store_compact_abort(s, c);
        return -1;
    }
    fsync_dir(s->path);
    s->log = std::fopen(s->path.c_str(), "ab");  // null: put re-opens lazily
    for (const auto& k : c->drop) s->index.erase(k);
    s->compacting = false;
    s->delta.clear();
    delete c;
    const int64_t after = file_bytes(s->path);
    return before > after ? before - after : 0;
}

// One-shot convenience wrapper over the phases (same-thread callers).
int64_t hs_store_compact(HsStore* s, const uint8_t* blob, uint64_t blob_len) {
    HsCompact* c = hs_store_compact_begin(s, blob, blob_len);
    if (!c) return -1;
    if (hs_store_compact_write(c) != 0) {
        hs_store_compact_abort(s, c);
        return -1;
    }
    return hs_store_compact_commit(s, c);
}

void hs_store_close(HsStore* s) {
    if (s->log) std::fclose(s->log);
    delete s;
}

}  // extern "C"
